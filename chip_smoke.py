"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py [--part fleet|train|tp|pp|genmesh|combos]

From the root of a checkout, on a machine with one CUDA card and ``nvcc``
(``$CUDA_HOME/bin`` or on ``PATH``). It imports nothing of JAX or of the JAX
package. Phases, each of which raises on failure (the exit code is then
nonzero and no result line is printed):

1. the card's name and power limit (``nvidia-smi``);
2. build the kernel libraries from the sources in the checkout, one nvcc
   for each of the seven sources, and the native host runtime
   (``orion_tpu_torch/runtime/*.cc``, g++), all started together; print
   ptxas' register, spill and shared-memory lines;
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
   then the sp part (``sp_phase``: four ranks, processes of this script
   sharing the card over gloo: rows 6-8 with shift / q_offset and the
   parts of rows 1, 3, 4 against their plain versions, the sp bodies
   against single-device attention, sp-4 training against its sp=1 twin)
   and the dp, tp and pp parts (``mesh_parts``: their runs share one spawn
   of 2 ranks and one of 4, so each rank's start and its first step's
   warm-up are paid once): the dp part (four ranks over gloo, one process group
   and a mesh a run: lm_1b3 at full width, 4 blocks, B 8 x 1024 at fsdp
   4, dp 2 x fsdp 2 and dp 4, the dropless moe_1b3_4e at dp 2 x fsdp 2,
   the 4-block hybrid at dp 2 x sp 2, a tiny fp32 hybrid at dp 2 x fsdp 2,
   each against its dp=1 twin within the sp part's limits with exact
   launches a rank; fsdp 4's resident bytes a quarter and its peak below
   dp 4's; an fsdp-4 checkpoint's round trip bitwise; step ms and the
   host ms in the collectives logged), then the tp part (``tp_phase``:
   tensor parallelism, ranks of this script sharing the card over gloo: (a)
   lm_1b3 at full width, 4 blocks, B 8 x 1024, two AdamW steps at tp 2 on
   2 ranks against its tp=1 twin within the dp part's limits, each rank's
   peak memory below the twin's; (b) on 4 ranks at 4 blocks the hybrid at
   dp 2 x tp 2 (rows 6-8 and 1, 3, 4 at 8 heads a rank), lm_1b3 at sp 2 x
   tp 2 (the sp parts at local heads), the dropless moe_1b3_4e at fsdp 2 x
   tp 2 (rows 9-10 on the local hidden slice), each against its tp=1 twin
   the same way; (c) generate at tp 2 on 2 ranks for lm_1b3 and hybrid_1b3
   at 4 blocks: the tp=1 run's 32 greedy tokens teacher-forced, each
   step's logits and this rank's heads of every layer's state after the
   prefill and the last step against tp=1, the free-running greedy tokens
   that match counted; launches exact a rank, counted by kernel name,
   ``launches_tp``), then the pp part (``pp_phase``: GPipe stages over
   depth, ranks of this script sharing the card over gloo: (a) lm_1b3 at
   full width, 4 blocks, B 8 x 1024, two AdamW steps at pp 2 (2 blocks a
   stage, 8 microbatches) on 2 ranks against its pp=1 twin within the dp
   part's limits, each rank's peak memory below the twin's, the leaves
   every stage holds bitwise on both ranks, the host ms a rank waits on its
   neighbour beside the bubble; (b) on 4 ranks the hybrid at 8 blocks at pp
   2 x dp 2, the dropless moe_1b3_4e at 8 blocks at pp 2 x fsdp 2 (its twin
   replaying the pipeline's routing), lm_1b3 at 4 blocks at pp 2 x sp 2,
   each against its pp=1 twin the same way; (c) (a)'s step-2 checkpoint,
   the pp=1 file, loaded by a pp=1 Trainer bitwise the gathered params,
   and its eval by ``orion_tpu_torch.evaluate`` against the pp Trainer's
   own; launches exact a rank, a stage's blocks once a microbatch, every
   one recomputed, ``launches_pp``), then the genmesh part
   (``genmesh_phase``: ``generate`` on the meshes the JAX CLI takes, in the
   same two spawns: G1-G4 of ``GENMESH_2`` / ``GENMESH_4``, lm_1b3 at 4
   blocks at sp 2, dp 2 and fsdp 2, the dropless MoE at dp 2, the hybrid at
   sp 2, sp 4 on a padded prompt, int8 and int4 at dp 2 x tp 2, each
   teacher-forced against its one-rank twin within tp's limits with every
   launch of rows 1, 6, 9 and 14 held against its plain version, the
   tokens bitwise across ranks, launches exact, ``launches_genmesh``), then
   the combos part (``combos_phase``: the mesh combinations of A12 step 7
   in the same two spawns, the comment above ``COMBOS_DEPTH``: M1 the
   dropless MoE trained at sp 2, rows 9-10 on each rank's token shard; M2
   its ``generate`` at sp 2; M3 lm_1b3 with dropout at dp 2 x tp 2 and sp
   2 x dp 2, every mask bitwise the twin's; M4 ``train_lra`` at dp 2; each
   against its one-rank twin, ``launches_combos``);
   each part runs alone as ``cs.sp_phase(...)`` / ``cs.dp_phase(dev)`` /
   ``cs.tp_phase(dev)`` / ``cs.pp_phase(dev)`` / ``cs.genmesh_phase(dev)``
   / ``cs.combos_phase(dev)`` after ``cs.build(mods)``, and ``python3
   chip_smoke.py --part tp`` (or ``--part pp``, ``--part genmesh``, ``--part
   combos``) runs the build, the kernel checks and that part alone;
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
9. training resilience and train -> checkpoint -> generate: (R1) the
   library ``train()`` of that config with ``FaultPlan().preempt_at(2)``, a
   real SIGTERM to this process that the run's PreemptionGuard turns into a
   5.3 GB emergency checkpoint at step 2 (a temporary directory, free disk
   checked first, removed after), then ``train()`` resumed from it to step
   4: params and Adafactor state bitwise the uninterrupted trainer's, the
   launches of both runs exact; the resumed run's final checkpoint loaded
   with ``generate.load_model`` (memory-mapped, manifest-verified) and
   ``generate`` of 4 x 1024 prompts for 32 greedy tokens from it, in bf16
   and at int4, against the same from the in-memory trained model: tokens
   and prefill logits bitwise, exact launches (row 14 at int4); the runs'
   and the load's seconds. Then (R2) ``python -m orion_tpu_torch.train``
   on lm_1b3 cut to 4 blocks (2 recomputed), AdamW, B 8 x 1024 of
   ``data/train.bin`` through the native loader, with ``--step-timeout
   120 --preempt-grace 30 --metrics-path``: one run SIGTERMed by a monitor
   process once its log shows step 2 (exit 0, ``preempted at step N``, only
   an off-cadence step-N checkpoint, a flight dump holding
   ``train_preempt``, its registry's step N and ``train_steps_total`` N -
   1, stderr naming the native loader), its rerun (``resumed from step
   N``) ending on a checkpoint bitwise, tensor by tensor, an uninterrupted
   run's started beside it; and meanwhile (R3) the same 4-block model in
   this process: ``poison_nan_at(2)`` (params after step 2 bitwise those
   after step 1, one non-finite step, step 3 finite), ``fail_io("ckpt.save",
   2, times=2)`` (the save lands after two retries and verifies),
   ``corrupt_step`` on the newest step (the restore falls back to step 1
   with a warning, the pinned step raises), ``fail_io("data.batch", 1,
   times=2)`` on ``data/train.bin`` (batches bitwise the numpy twin's),
   launches exact. ``python3 chip_smoke.py --part train`` runs the build,
   the kernel checks, this phase and the adafactor_fused training before it
   alone; each part's seconds are logged;
10. the model and training options at ``lm_1b3``'s width, cut to 4 blocks
   (2 recomputed) beside the same cut of the elu+1 AdamW run: the ``favor``
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
   untied head at int8 (the int8 ``lm_head_kernel_q``); ``remat_policy=
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
12. serving through ``serving.SlotEngine`` at 4 slots, chunk 16, each
   model cut to 4 blocks (the hybrid's keeping swa and linear layers; the
   CLIs below serve the full depth), on
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
   limit); then the engine's ladder with NaN in one slot's rows (the rewind
   bitwise, the re-prefill held as ``DecodeSession``'s rung, an exhausted
   ladder failing one request only), suspend and resume bitwise the
   uninterrupted request; ``DecodeSession`` on lm_1b3, its tokens bitwise
   ``generate``'s (a), with a NaN injected (rewind bitwise (e),
   re-prefill, ``LadderExhausted``); decode ms/token at 4 busy slots through
   the engine and a 256-token piece's boundary cost; each phase's time;
   then the same requests through ``serving.Server`` (all submitted, then
   ``serve()``), each bitwise the engine run's: lm_1b3 bf16 cut to 4 blocks
   (after that cut's own main path and "f") greedy and
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
   stats line; then the Server's stores (``stores_check``, in a temporary
   directory, free disk checked first) on lm_1b3 bf16 and int4 cut to 4
   blocks and on hybrid_1b3 cut to 4 blocks: 4 requests
   sharing a declared 768-token prefix, request 0 a
   miss whose publish runs (a solo prefill: row 1 once for each linear
   layer, row 6 for each swa layer), 1-3 hits whose pieces cover only
   their suffixes, every hit bitwise the request served cold for lm_1b3
   (greedy and sampled), the hybrid's held to (g)'s limits; a session's
   two turns, the second suspended by a SIGTERM and resumed from disk by a
   fresh Server, bitwise one uninterrupted request (lm_1b3, greedy and
   sampled, bf16 and int4), an int4 session refused by a full-precision
   Server; on lm_1b3 bf16 a corrupted latest entry falling back to its
   previous generation and a wholly corrupt one to a cold prefill, and an
   outage (sustained "eio" on the session save and the prefix load) with
   every request ok and bitwise, health DEGRADED "store-outage:*", the
   breakers recovering by their probes and the dirty session landing;
   launches exact for every wave; readings: a hit's and a miss's first
   token, the publish's ms, the entry's bytes, session save and load ms
   and bytes; then the speculative part (``spec_check``, depth 4, no
   floor) on lm_1b3 bf16 and int4 and on hybrid_1b3, each cut to 4 blocks
   (the hybrid's swa, swa, swa, linear; each cut part after its own main
   path and "f", whose plain runs speculation is held against; the CLIs
   serve the full depth): ``verify_step`` at 4
   rows x 5 fed tokens bitwise 5 ``decode_step`` calls, the advance at keep
   0, 2, 5 bitwise the walk (rings included), every product of the piece
   and a draft step at 64 rows; the plan served again for each (sampling,
   admission) pair of the plain runs above, every request bitwise the
   plain run's, every pure-decode boundary a round, lm_1b3 (its draft the
   whole model) accepting every draft, launches exact (rows 1 and 6 only in
   admissions; row 14 at int4 in the draft steps and the verify pieces);
   on lm_1b3 bf16 and the hybrid the rewind rung on a mid-round slot
   bitwise, a speculating Server bitwise the engine with its speculation
   section and counters consistent, readings (decode ms/token at 4 busy
   slots with speculation off and at depth 2 and 4 in turns, a round's ms,
   the acceptance rate); on the hybrid ``python -m orion_tpu_torch.serving
   --spec-depth 4`` in a subprocess (exit 0, its stats and speculation
   lines); on lm_1b3 bf16 the fault the row count exists for (the verify
   piece at its own row count): which checks see it, recorded;
13. the fleet part (``fleet_phase``) on lm_1b3 bf16 at full width and
   depth, six text prompts of LM_PLAN's lengths, 64 greedy tokens each,
   host admission: (S) one Server run plain and one with the live
   endpoints (``metrics_port=0``), a declared latency SLO, cost attribution
   and a profile directory: /profilez?chunks=4 armed, /metrics, /healthz
   (200 while serving), /statusz, /slo and /costz read mid-run, tokens
   bitwise the plain run's, the requests' device_ms adding up to the
   boundaries' chunk_ms within 1e-6, the torch.profiler trace of the 4
   chunks holding CUDA kernel events (its device-busy share logged); (F1)
   the requests routed over two ``LocalReplica`` s (two Servers, two
   threads) bitwise the Server's, row 1's launches exact (24 a solo
   prefill x 6); (F2) ``python -m orion_tpu_torch.fleet --config lm_1b3
   --replicas 2`` with a shared session directory: replica 0's child
   SIGTERMed once its heartbeat shows a boundary, its turns suspended
   mid-stream and continued on the other replica, stdout bitwise F1's, the
   aggregated endpoints read mid-run, exit 0; each child's time to ready
   logged. ``python3 chip_smoke.py --part fleet`` runs the build, the
   kernel checks and this part alone;
14. a ``kernels`` JSON line (25 entries: the 14 rows, rows 1-10 and 14
   once for each variant; rows 1, 3 and 4 also with their launches under
   the options of phase 10, rows 1, 6 and 14 on the serving path, through
   ``SlotEngine``, through the Server, through its stores and through the
   speculative part, every row's launches through the in-process fleet,
   ``launches_fleet``, rows 1, 3, 4 and 11-13 in R1's and R3's runs,
   ``launches_train_resilience``, and every kernel's launches in the tp
   and pp parts, ``launches_tp`` and ``launches_pp``), then the result
   line ``{"ok": true,
   "device": {...}}`` last.
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
    one nvcc for each source, and the native host runtime (g++), all started
    together; print each build's time and ptxas lines."""
    from orion_tpu_torch.ops.kernels import library

    sources = [src for m in modules for src in m.SOURCES.values()]

    def one(src):
        t = time.perf_counter()
        path, out = library.build(src)
        return src, path, out, time.perf_counter() - t

    def native():  # the host runtime (g++): the data loader the train CLI reads through
        from orion_tpu_torch import runtime

        t = time.perf_counter()
        return runtime.build(), time.perf_counter() - t

    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host = pool.submit(native)
        for src, path, out, sec in pool.map(one, sources):
            log(f"built {path.name} from {src.relative_to(ROOT)} in {sec:.1f} s")
            for line in out.splitlines():
                if any(w in line for w in ("entry function", "registers", "spill", "smem")):
                    log("  ptxas:", line.strip())
        path, sec = host.result()
        log(f"built {path.name} from orion_tpu_torch/runtime/*.cc in {sec:.1f} s")


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
        # a caller running several batches sets ``epoch`` before each: the
        # choices are keyed by (layer, epoch), so each batch pins its own
        self.epoch = 0

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
        pinned = self.routes.setdefault((self.current, self.epoch), ids)
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


class PipelinePinnedRouting(PinnedRouting):
    """``PinnedRouting`` for a pipeline stage: its MoE layers route each of
    ``n_micro`` microbatches a step, so a choice is keyed by (global layer,
    epoch, microbatch). A layer's calls in a step come in the schedule's
    order: the forward of microbatches 0 .. n_micro - 1, then their
    recomputations n_micro - 1 .. 0 in the backward (every block is
    recomputed under pp), so the call count gives the microbatch."""

    def __init__(self):
        super().__init__()
        self.n_micro, self.full_manual, self.calls = 1, False, {}

    def attach(self, model):
        for i, blk in model.blocks.items():  # a stage's blocks by their global index
            if isinstance(blk.mlp, self.moe.MoEMLP):
                blk.mlp.register_forward_pre_hook(lambda mod, args, i=i: setattr(
                    self, "current", i))
        return model

    def choice(self, probs, k):
        key = (self.current, self.epoch)
        c = self.calls[key] = self.calls.get(key, 0) + 1
        n = self.n_micro
        micro = c - 1 if c <= n else 2 * n - c
        ids, _ = self.real(probs, k)
        pinned = self.routes.setdefault((*key, micro), ids)
        if pinned is not ids:
            self.flips += int((pinned != ids).any(-1).sum())
            self.choices += ids.shape[0]
        g = probs.gather(-1, pinned)
        return pinned, g / g.sum(-1, keepdim=True).clamp_min(1e-9)


class ShardPinnedRouting(PinnedRouting):
    """``PinnedRouting`` for ``generate`` on an sp mesh against its one-rank
    twin: each MoE layer's calls are keyed by their order (the prefill, then
    one a decode step), recorded on the twin's run and replayed on the sp
    rank's, whose prefill routes its shard of the prompt's tokens (the
    twin's [B T, k] choices cut to tokens [s T / sp, (s + 1) T / sp) of
    each row). ``restart()`` before the replayed run."""

    def __init__(self, t, sp, sp_rank):
        super().__init__()
        self.t, self.sp, self.s, self.calls = t, sp, sp_rank, {}

    def restart(self):
        self.calls = {}

    def choice(self, probs, k):
        c = self.calls[self.current] = self.calls.get(self.current, -1) + 1
        ids, _ = self.real(probs, k)
        pinned = self.routes.setdefault((self.current, c), ids)
        if pinned is not ids:
            if pinned.shape[0] != ids.shape[0]:  # the sp prefill: this rank's tokens
                t_loc = self.t // self.sp
                pinned = pinned.reshape(-1, self.t, k)[:, self.s * t_loc:(self.s + 1) * t_loc]
                pinned = pinned.reshape(-1, k)
            self.flips += int((pinned != ids).any(-1).sum())
            self.choices += ids.shape[0]
        g = probs.gather(-1, pinned)
        return pinned, g / g.sum(-1, keepdim=True).clamp_min(1e-9)


class MaskTap:
    """Every dropout mask ``models/transformer.py`` draws within ``with
    tap:`` (``dropout_keep``), by its block key, site, first global row and
    token, and shape: with ``keep_full`` the masks themselves on the host
    (a twin's), else a crc32 of each (a mesh rank's). A draw equal to an
    earlier one of the same key, position and shape (a recomputation's)
    counts in ``redraws``, one that differs in ``differs``."""

    def __init__(self, keep_full=False):
        from orion_tpu_torch.models import transformer

        self.mod, self.real, self.keep_full = transformer, transformer.dropout_keep, keep_full
        self.draws, self.redraws, self.differs = {}, 0, 0

    def keep(self, key, site, shape, rate, device=None):
        import zlib

        keep = self.real(key, site, shape, rate, device)
        host = keep.cpu()
        val = host if self.keep_full else zlib.crc32(host.numpy().tobytes())
        ident = (key.seed, site, key.row, key.token, tuple(keep.shape))
        old = self.draws.setdefault(ident, val)
        if old is not val:
            same = torch.equal(old, val) if self.keep_full else old == val
            self.redraws += int(same)
            self.differs += int(not same)
        return keep

    def __enter__(self):
        self.mod.dropout_keep = self.keep
        return self

    def __exit__(self, *exc):
        self.mod.dropout_keep = self.real

    def gather(self):
        """Every rank's draws (crc32s) and counts, in rank order: a
        collective over the world."""
        import torch.distributed as dist

        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, {"draws": self.draws, "redraws": self.redraws,
                                     "differs": self.differs})
        return out

    def check(self, ranks, m):
        """This (full) tap's masks cut at each rank's rows and tokens against
        the ranks' draws (``gather``) -> {"compared", "equal", "missing",
        "redraws", "differs", "keys"}: every key a rank drew must be the
        twin's, every draw equal to the twin mask's slice."""
        import zlib

        whole = {(seed, site): mask for (seed, site, _, _, _), mask in self.draws.items()}
        out = {"compared": 0, "equal": 0, "missing": 0, "keys": len(whole),
               "redraws": self.redraws + sum(r["redraws"] for r in ranks),
               "differs": self.differs + sum(r["differs"] for r in ranks)}
        for r in ranks:
            for (seed, site, row, token, shape), crc in r["draws"].items():
                full = whole.get((seed, site))
                if full is None:
                    out["missing"] += 1
                    continue
                cut = full[row:row + shape[0], token:token + shape[1], :shape[2]]
                out["compared"] += 1
                out["equal"] += int(tuple(cut.shape) == shape and zlib.crc32(
                    cut.contiguous().numpy().tobytes()) == crc)
        return out


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
    launch_audit = LaunchAudit(mods) if audit else contextlib.nullcontext()
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


def load_phase(dev, mods, trainer, ckpt_dir, prompt_len=1024, new_tokens=32):
    """Train -> checkpoint -> generate at full width: the params of the
    checkpoint in ``ckpt_dir`` at ``trainer.step_count`` (written by the
    resumed run of ``preempt_resume``, bitwise ``trainer``'s state) loaded
    with ``generate.load_model`` (``load_params``: memory-mapped, verified
    against the manifest), and ``generate`` of 4 x ``prompt_len`` prompts
    for ``new_tokens`` greedy tokens from the loaded model against the same
    from the in-memory trained model: tokens and prefill logits bitwise
    (the same card, kernels and casts), in bf16 and at int4 (row 14
    launched, its count read; the counts set to 0 just before each)."""
    import os

    from orion_tpu_torch.generate import (
        SampleConfig, cast_params_for_inference, generate, load_model, quantize_for_decode)
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.training.checkpoint import step_path

    cfg = trainer.model.cfg
    size = os.path.getsize(step_path(ckpt_dir, trainer.step_count))
    t0 = time.perf_counter()
    loaded, step = load_model(cfg, ckpt_dir, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"load phase: loaded the params of step {step} ({size / 1e9:.3f} GB on disk, "
        f"{trainer.opt.__class__.__name__} state beside them) in {load_s:.1f} s")
    if step != trainer.step_count:
        raise AssertionError(f"loaded step {step}, want {trainer.step_count}")
    memory = TransformerLM(cfg, device=dev)
    memory.load_state_dict({n: p.detach() for n, p in trainer.params.items()})
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, prompt_len), dtype=np.int64)).to(dev)
    greedy = SampleConfig(temperature=0.0)
    res = {"load_s": load_s, "bytes": size, "step": step}
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


def _state_mismatches(a, b):
    """The leaves of two trainers' states (params, then the optimizer's
    state dict) that are not bitwise equal, by name."""
    out = [n for n, p in a.params.items() if not torch.equal(p, b.params[n])]
    sa, sb = a.opt.state_dict(), b.opt.state_dict()
    for key, va in sa.items():
        if isinstance(va, dict):
            out += [f"opt/{key}/{n}" for n, t in va.items() if not torch.equal(t, sb[key][n])]
        elif int(va) != int(sb[key]):
            out.append(f"opt/{key}")
    return out


def preempt_resume(dev, mods, trainer, ckpt_dir):
    """(R1) ``train()`` of ``trainer``'s config (lm_1b3 at full depth,
    adafactor_fused, B 8 x 1024, the same seed and synthetic batches) with
    ``FaultPlan().preempt_at(2)``: a real SIGTERM to this process at step 2's
    boundary, which the run's PreemptionGuard turns into an emergency
    checkpoint in ``ckpt_dir`` and a return; then ``train()`` again, resumed
    from it, to the config's last step. The resumed run's params and
    Adafactor state must be bitwise ``trainer``'s (the uninterrupted run),
    and its launches exact: the per-step counts times the steps of the two
    runs (counts set to 0 just before the first, read after the second)."""
    import os

    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.train import train

    cfg = dataclasses.replace(trainer.cfg, ckpt_dir=ckpt_dir, ckpt_keep=1, preempt_grace=600.0)
    res = {}
    gc.collect()
    _reset_counts(mods)
    plan = inject.FaultPlan().preempt_at(2)
    t0 = time.perf_counter()
    with inject.inject(plan):
        tr, _ = train(cfg, data="synthetic", resume=False, device=dev)
    torch.cuda.synchronize()
    res["preempted_s"] = time.perf_counter() - t0
    res.update(preempted_at=tr.preempted_at, delivered=list(plan.delivered),
               files=sorted(os.listdir(ckpt_dir)))
    flights = sorted(os.listdir(os.path.join(ckpt_dir, "flight")))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr, _ = train(cfg, data="synthetic", resume=True, device=dev)
    torch.cuda.synchronize()
    res["resumed_s"] = time.perf_counter() - t0
    counts = _counts(mods)
    res["launches"] = counts
    mism = _state_mismatches(tr, trainer)
    res.update(resumed_step=tr.step_count, mismatched=mism[:8], n_mismatched=len(mism))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {k: v * cfg.steps for k, v in _af_per_step(trainer).items()}
    log(f"R1 lm_1b3 adafactor_fused preempted by a SIGTERM at step 2 ({plan.delivered}): "
        f"stopped at {res['preempted_at']} in {res['preempted_s']:.1f} s with {res['files']} "
        f"and flight dumps {flights}; resumed to step {res['resumed_step']} in "
        f"{res['resumed_s']:.1f} s (restore, 2 steps, the final save); params and Adafactor "
        f"state bitwise the uninterrupted run's: {not mism} ({len(mism)} leaves differ: "
        f"{mism[:8]}); launches over both runs {counts} (want {per_step})")
    if not (res["preempted_at"] == 2 and plan.delivered == ["train.step_boundary@2"]
            and "step-00000002.pt" in res["files"]
            and any(f.endswith("train-preempt.json") for f in flights)):
        raise AssertionError(f"R1: the preemption did not stop at step 2 with its checkpoint: "
                             f"{res}, {flights}")
    if res["resumed_step"] != cfg.steps or mism:
        raise AssertionError(f"R1: the resumed run is not bitwise the uninterrupted one: {res}")
    if counts != per_step:
        raise AssertionError(f"R1 launches {counts}, want {per_step}")
    return res


def _af_per_step(trainer):
    """Exact launches of one lm_1b3 adafactor_fused training step."""
    m = trainer.model.cfg
    lin, _, lin_remat, _ = _layer_counts(m)
    want = dict.fromkeys(KERNELS, 0)
    n_af = _af_kernel_leaves(trainer.params)
    want.update(causal_dot_norm_wgmma=lin + lin_remat, causal_dot_dq_den_wgmma=lin,
                causal_dot_rev_den_wgmma=lin, adafactor_sums=2 * n_af,
                adafactor_rms=2 * n_af, adafactor_apply=n_af)
    return want


def adafactor_resilience(dev, mods, trainer):
    """R1, then the load phase from the resumed run's final checkpoint, in a
    temporary directory (free disk checked first, removed after): two
    checkpoints of the trainer's state may be on disk at once."""
    import shutil
    import tempfile

    need = sum(t.numel() * t.element_size() for t in _tree_leaves(trainer.state_dict()))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"R1: checkpoints of {need / 1e9:.3f} GB into {tmp} ({free / 1e9:.1f} GB free)")
        if free < 2 * need + 2**30:
            raise RuntimeError(f"{tmp} has {free / 1e9:.1f} GB free; two checkpoints need "
                               f"{2 * need / 1e9:.1f} GB and 1 GiB to spare")
        r1 = preempt_resume(dev, mods, trainer, tmp)
        r1["load"] = load_phase(dev, mods, trainer, tmp)
        return r1
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
    launch_audit = LaunchAudit((causal_dot,)) if audit else contextlib.nullcontext()
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
    """Every launch of the rows it wraps (``rows``, of 1, 3, 4, 6, 9, 10 and 14)
    inside ``with LaunchAudit(mods, rows):`` held against its plain version
    on the same inputs, at the kernel checks' limits: row 1's out within
    ``OUT_ATOL + rtol |ref|`` (``OUT_RTOL`` for bf16, ``OUT_RTOL_FP32`` for
    fp32) and its S, z (num, den in the parts form) within ``STATE_RTOL``;
    rows 3 and 4's dq, dk, dv by ``_grad_reading`` and dS0, dz0 within
    ``STATE_RTOL``; row 6's out by ``_grad_reading`` at ``FLASH_RTOL`` /
    ``FLASH_ATOL_OF_MAX`` and its lse within ``LSE_RTOL``; row 9's y at
    ``GMM_RTOL`` / ``GMM_ATOL_OF_MAX``; row 10's dw by ``_dw_reading``
    (``GMM_DW_RTOL_OF_MAX`` of each expert's largest); row 14's y at
    ``Q4_RTOL`` / ``Q4_ATOL_OF_MAX``. ``mods``: (causal_dot, flash_attention, gmm,
    q4_matmul, ...), as far as the rows need. Each wrapper calls the kernel
    once (its count moves once) and the plain version beside it, uncounted.
    ``worst`` keeps each quantity's largest share of its limit (above 1
    fails), ``launches`` each row's count, ``shapes`` each row's distinct
    launches (shapes, dtype, variant, options)."""

    def __init__(self, mods, rows=(1, 3, 4)):
        mod = {1: 0, 3: 0, 4: 0, 6: 1, 9: 2, 10: 2, 14: 3}
        attr = {1: "causal_dot_norm_cuda", 3: "causal_dot_dq_den_cuda",
                4: "causal_dot_rev_den_cuda", 6: "flash_fwd_cuda", 9: "gmm_cuda",
                10: "gmm_dw_cuda", 14: "q4_matmul_cuda"}
        wrap = {1: self.norm, 3: self.dq_den, 4: self.rev_den, 6: self.flash, 9: self.gmm,
                10: self.gmm_dw, 14: self.q4}
        self.mods = mods
        self.slots = [(mods[mod[r]], attr[r], wrap[r]) for r in rows]
        self.real = {attr[r]: getattr(mods[mod[r]], attr[r]) for r in rows}
        self.worst, self.launches, self.shapes = {}, {}, {}

    def _note(self, row, key, share, shape):
        name = f"{row} {key}"
        self.worst[name] = max(self.worst.get(name, 0.0), float(share))
        self.shapes.setdefault(row, set()).add(shape)

    def _count(self, row):
        self.launches[row] = self.launches.get(row, 0) + 1

    def norm(self, q, k, v, s0=None, z0=None, *, eps=1e-6, with_parts=False):
        cd = self.mods[0]
        res = self.real["causal_dot_norm_cuda"](q, k, v, s0, z0, eps=eps, with_parts=with_parts)
        ref = cd.causal_dot_norm_plain(q, k, v, s0, z0, eps=eps, with_parts=with_parts)
        rtol = OUT_RTOL if q.dtype == torch.bfloat16 else OUT_RTOL_FP32
        shape = (f"q {list(q.shape)} {str(q.dtype)[6:]} {cd.causal_dot_norm_variant(q, k, v)}"
                 + (" with parts" if with_parts else ""))
        out, r_out = res[0].float(), ref[0].float()
        self._note("row 1", "out", ((out - r_out).abs() / (OUT_ATOL + rtol * r_out.abs())).max(),
                   shape)
        for key, got, r in zip(("S", "z", "num", "den"), res[1:], ref[1:]):
            if got is not None:
                self._note("row 1", key, _rel(got, r) / STATE_RTOL, shape)
        self._count("row 1")
        return res

    def dq_den(self, g, v, k, gden, s0=None, z0=None):
        cd = self.mods[0]
        dq = self.real["causal_dot_dq_den_cuda"](g, v, k, gden, s0, z0)
        self._note("row 3", "dq", _grad_reading(dq, cd.causal_dot_dq_den_plain(
            g, v, k, gden, s0, z0))["over_limit"], f"g {list(g.shape)} {str(g.dtype)[6:]}")
        self._count("row 3")
        return dq

    def rev_den(self, q, k, v, g, gden, gsf=None, gzf=None):
        cd = self.mods[0]
        res = self.real["causal_dot_rev_den_cuda"](q, k, v, g, gden, gsf, gzf)
        ref = cd.causal_dot_rev_den_plain(q, k, v, g, gden, gsf, gzf)
        shape = f"q {list(q.shape)} {str(q.dtype)[6:]}"
        for key, got, r in zip(("dk", "dv"), res[:2], ref[:2]):
            self._note("row 4", key, _grad_reading(got, r)["over_limit"], shape)
        for key, got, r in zip(("dS0", "dz0"), res[2:], ref[2:]):
            if got is not None:
                self._note("row 4", key, _rel(got, r) / STATE_RTOL, shape)
        self._count("row 4")
        return res

    def flash(self, q, k, v, **opts):
        fa = self.mods[1]
        out, lse = self.real["flash_fwd_cuda"](q, k, v, **opts)
        r_out, r_lse = fa.flash_fwd_plain(q, k, v, **opts)
        shape = (f"q {list(q.shape)} k {list(k.shape)} {str(q.dtype)[6:]} "
                 f"{fa.flash_fwd_variant(q, k, v)} window={opts.get('window')} "
                 f"shift={opts.get('shift', 0)} q_offset={opts.get('q_offset', 0)}")
        self._note("row 6", "out", _grad_reading(out, r_out, FLASH_RTOL[q.dtype],
                                                 FLASH_ATOL_OF_MAX)["over_limit"], shape)
        diff = (lse - r_lse).abs()
        self._note("row 6", "lse", (diff / (LSE_RTOL * r_lse.abs().clamp_min(1.0))).max(), shape)
        self._count("row 6")
        return out, lse

    def gmm(self, x, w, tile_expert, transpose_w=False):
        gm = self.mods[2]
        y = self.real["gmm_cuda"](x, w, tile_expert, transpose_w)
        shape = (f"x {list(x.shape)} w {list(w.shape)} {str(x.dtype)[6:]} "
                 f"{gm.gmm_variant(x, w, transpose_w)}")
        self._note("row 9", "y", _grad_reading(y, gm.gmm_torch(x, w, tile_expert, transpose_w),
                                               GMM_RTOL[x.dtype], GMM_ATOL_OF_MAX)["over_limit"],
                   shape)
        self._count("row 9")
        return y

    def gmm_dw(self, x, g, tile_expert, n_experts):
        gm = self.mods[2]
        dw = self.real["gmm_dw_cuda"](x, g, tile_expert, n_experts)
        reading = _dw_reading(dw, gm.gmm_dw_torch(x, g, tile_expert, n_experts), tile_expert)
        shape = (f"x {list(x.shape)} g {list(g.shape)} {str(x.dtype)[6:]} "
                 f"{gm.gmm_dw_variant(x, g)}")
        self._note("row 10", "dw", reading["over_limit"] if reading["absent_zero"]
                   and reading["well_formed"] else float("inf"), shape)
        self._count("row 10")
        return dw

    def q4(self, x, p, s):
        q4 = self.mods[3]
        y = self.real["q4_matmul_cuda"](x, p, s)
        shape = f"x {list(x.shape)} p {list(p.shape)} {q4.q4_matmul_variant(x, p, s)}"
        self._note("row 14", "y", _grad_reading(y, q4.q4_matmul_torch(x, p, s), Q4_RTOL[x.dtype],
                                                Q4_ATOL_OF_MAX)["over_limit"], shape)
        self._count("row 14")
        return y

    def __enter__(self):
        for mod, attr, fn in self.slots:
            setattr(mod, attr, fn)
        return self

    def __exit__(self, *exc):
        for mod, attr, _ in self.slots:
            setattr(mod, attr, self.real[attr])

    def reading(self):
        return {"worst": dict(self.worst), "launches": dict(self.launches),
                "shapes": {row: sorted(s) for row, s in self.shapes.items()}}

    def check(self, label):
        log(f"{label}: {self.launches} launches each held against its plain version on the "
            f"same inputs; largest share of the kernel limit by quantity "
            f"{ {k: float(f'{v:.3g}') for k, v in self.worst.items()} }")
        if not self.launches or any(v > 1.0 or not np.isfinite(v) for v in self.worst.values()):
            raise AssertionError(f"{label}: a launch disagrees with its plain version: "
                                 f"{self.worst}")
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


def run_plan(model, plan, sample, mode, only=None, seed0=100, fault=None, watch=False,
             spec_depth=0):
    """Serve ``plan``'s requests through a fresh engine (``mode``): request i
    is admitted at its first boundary or later, when a slot is free
    (``only``: those requests alone). ``fault``: an ``inject.FaultPlan``
    armed for the run. ``watch``: at every boundary the rows it must leave
    as they are -- free slots, and slots mid-prefill the piece does not go
    to -- come out bitwise as they went in (contract (c)). ``spec_depth``:
    speculative rounds of that many drafts at the pure-decode boundaries
    (no floor). -> (results by request, counts: solo prefills, unified and
    pure boundaries, rows held, and the rounds' accepted and rejected drafts
    and the rounds that rejected any)."""
    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.serving import DecodeRequest

    prompts = _serve_prompts(plan, model.cfg.vocab_size)
    rounds = []
    eng = serve_engine(model, mode, spec_depth=spec_depth, spec_min_accept=0.0,
                       on_event=lambda k, f: rounds.append(f) if k == "spec_round" else None)
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
            if stats["boundaries"] > (64 if not spec_depth else 64 * SERVE_CHUNK):
                raise AssertionError("the slot plan did not drain")
    if spec_depth:
        stats.update(rounds=len(rounds), accepted=sum(f["accepted"] for f in rounds),
                     rejected=sum(f["rejected"] for f in rounds),
                     rejecting_rounds=sum(f["rejected"] > 0 for f in rounds))
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


# the stores part: 4 requests sharing a declared 768-token prefix (3 pieces
# of 256, 12 of row 1's chunks); request 0 misses and publishes, 1-3 hit
STORE_PREFIX = 768
STORE_SUFFIXES = (300, 77, 150, 220)


def _store_prompts(vocab):
    rng = np.random.default_rng(11)
    pre = rng.integers(0, vocab, (1, STORE_PREFIX), dtype=np.int64)
    return [np.concatenate([pre, rng.integers(0, vocab, (1, n), dtype=np.int64)], axis=1)
            for n in STORE_SUFFIXES]


def _store_marks(srv):
    """What a stores run's launches follow, from the Server's flight ring and
    counters: prefill pieces, prefix publishes, boundaries."""
    return (len(srv.flight.events("prefill_piece")), len(srv.flight.events("prefix_publish")),
            srv.stats["chunks"])


def _store_want(cfg, quant, before, after):
    """Exact launches between two marks of an in-scan Server: row 1 for each
    linear layer of a piece and of a publish's solo prefill, row 6 for each
    softmax / swa layer of a publish's prefill (the pieces' are plain), row
    14 for each int4 layer and decode step."""
    lin, attn, _, _ = _layer_counts(cfg)
    pieces, pubs, chunks = (a - b for a, b in zip(after, before))
    want = dict.fromkeys(KERNELS, 0)
    want.update(causal_dot_norm_wgmma=lin * (pieces + pubs), flash_fwd_wgmma=attn * pubs,
                q4_matmul_mma=_q4_per_step(cfg) * chunks * SERVE_CHUNK if quant == "int4" else 0)
    return want


def _store_wave(mods, srv, reqs, label, what, cfg, quant, fault=None, statuses=("ok",),
                idle=True):
    """``reqs`` submitted to ``srv`` and served (to idle, or with ``idle``
    False to the end of a SIGTERM drain), ``fault`` armed, launches counted
    from 0 and held exact, each request's status one of ``statuses``. ->
    (pendings, launches)."""
    from orion_tpu_torch.resilience import inject

    gc.collect()
    _reset_counts(mods)
    before = _store_marks(srv)
    ps = [srv.submit(r) for r in reqs]
    with inject.inject(fault) if fault is not None else contextlib.nullcontext():
        rc = srv.serve(drain_when_idle=idle)
    torch.cuda.synchronize()
    counts = _counts(mods)
    want = _store_want(cfg, quant, before, _store_marks(srv))
    if rc != 0 or counts != want:
        raise AssertionError(f"{label} stores, {what}: serve() {rc}, launched {counts}, want "
                             f"{want}")
    for p in ps:
        if p.result is None or p.result.status not in statuses:
            raise AssertionError(f"{label} stores, {what}: a request ended "
                                 f"{p.result.status if p.result else p.error!r}")
    return ps, counts


def _pieces_by_request(srv, ps):
    return [sum(e.get("req") == p.rid for e in srv.flight.events("prefill_piece")) for p in ps]


def _timed_publish(srv, into):
    """Time the engine's publishes (a solo prefill, the state's copy to the
    host and the write), the card synchronized at both ends."""
    orig = srv.engine.publish_pending_prefixes

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = orig()
        torch.cuda.synchronize()
        if n:
            into.append((time.perf_counter() - t0) * 1e3)
        return n

    srv.engine.publish_pending_prefixes = timed


def _tap(store, into):
    """Collect a store's telemetry (op, ms[, bytes]) beside the Server's."""
    orig = store._observer

    def both(*a):
        into.append(a)
        orig(*a)

    store._observer = both


def _entry_vs_pieces(srv, entry, prompt, dev):
    """A published entry's state against the pieces' state of its prefix
    (the cold request's in-scan prefill over the same tokens): bitwise?, S
    and K/V max relative error (held to (g)'s limits)."""
    cfg = srv.engine.model.cfg
    _, st = _prefill_pieces(srv.engine.model, torch.from_numpy(prompt[:, :entry.t]).to(dev))
    kinds = cfg.resolved_layer_types
    read = [[{k: _readable_rows(cfg, lt, v.to(dev), entry.t) for k, v in a.items()}
             for lt, a in zip(kinds, sts)] for sts in (entry.state, st)]
    bit = all(torch.equal(a[k], b[k]) for a, b in zip(*read) for k in a)
    return bit, _state_err(*read)


def stores_check(dev, mods, model, label, card, quant="", fp=None, full=False):
    """The Server's stores at full width, 4 slots, chunk 16, pieces of 256
    (``quant``: the Server quantizes the fp32 ``fp`` itself). In a temporary
    directory (free disk checked first; removed after):

    (i) prefix -- 4 requests sharing a declared 768-token prefix (suffixes of
    300, 77, 150, 220), greedy and sampled (greedy only for a model with swa
    layers), served through a Server without a store (cold), then through one
    with ``prefix_dir``: request 0 misses and its publish runs, 1-3 hit;
    launches exact for each wave; every hit bitwise the cold request for a
    linear model (for the hybrid its greedy tokens equal, the entry's state
    within (g)'s limits of the pieces'); each request's pieces; readings:
    the publish's ms, the entry's bytes, the first token of request 0 hit
    against cold (three turns each, median). Where a hybrid hit's greedy
    tokens differ from the cold request's, each is held as the in-scan
    admission is against host admission: within ``LOGITS_ATOL`` of the
    maximum of a one-row walk fed them. ``full``: a second generation
    with the latest corrupted falls back to the first (a warning, the hit
    bitwise), every generation corrupted falls back to a cold prefill.

    (ii) sessions (linear models) -- a session's two turns (40 tokens, then
    64 of which a SIGTERM at its second boundary suspends all but the first
    40), the rest resumed from disk by a fresh Server and engine: bitwise
    one uninterrupted request of 104 tokens, greedy and sampled, launches
    exact; readings: save and load ms and bytes. At int4 a full-precision
    Server's resume is refused (``SessionIdentityError``).

    (iii) ``full``: an outage -- sessions and prefixes on one Server
    (breakers at one failure), turn 2 under ``degrade_site`` "eio" on
    ``serve.session_save`` and on ``serve.prefix_load``: every request ok and
    bitwise its clean run, zero failed, health DEGRADED "store-outage:*",
    both breakers tripped (the prefix one's probe, a directory scan outside
    the regime, may close it inside the outage); after the regime the probes
    close them, the dirty session lands and health is SERVING; turn 3 on
    top, bitwise."""
    import shutil
    import tempfile

    from orion_tpu_torch.generate import SampleConfig
    from orion_tpu_torch.models.transformer import init_decode_state
    from orion_tpu_torch.serving import DecodeRequest, Server

    cfg = model.cfg
    served, qmode = (fp, quant) if quant else (model, "off")
    linear = all(lt == "linear" for lt in cfg.resolved_layer_types)
    samples = {"greedy": SampleConfig(temperature=0.0), "sampled": SampleConfig(**SAMPLED_SERVE)}
    one = init_decode_state(cfg, 1, dev)
    state_bytes = sum(x.numel() * x.element_size() for st in one for x in st.values())
    del one
    prompts = _store_prompts(cfg.vocab_size)
    t_part = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stores_")
    res = {"launches": {}, "prefix": {}, "card": card}
    try:
        free = shutil.disk_usage(tmp).free
        need = 12 * state_bytes
        log(f"{label} stores: a decode state of {state_bytes / 2**20:.1f} MiB; {tmp} has "
            f"{free / 1e9:.1f} GB free")
        if free < need + 2**30:
            raise RuntimeError(f"{tmp} has {free / 1e9:.1f} GB free; the stores need "
                               f"{need / 1e9:.1f} GB and 1 GiB to spare")

        # (i) the prefix cache
        cold_by_sample = {}
        for sname in ("greedy", "sampled") if linear else ("greedy",):
            sample = samples[sname]
            reqs = [DecodeRequest(p, SERVE_NEW, sample, seed=300 + i, prefix_len=STORE_PREFIX)
                    for i, p in enumerate(prompts)]
            cold_srv = Server(served, _server_config("inscan", qmode=qmode, max_inflight=8))
            cold_ps, cold_counts = _store_wave(mods, cold_srv, reqs, label, f"{sname} cold", cfg,
                                               quant)
            cold = [p.result.tokens[0].tolist() for p in cold_ps]
            cold_by_sample[sname] = cold
            pdir = os.path.join(tmp, f"prefix-{sname}")
            srv = Server(served, _server_config("inscan", qmode=qmode, max_inflight=8,
                                                prefix_dir=pdir))
            pub_ms, prefix_io = [], []
            _timed_publish(srv, pub_ms)
            _tap(srv.prefix_store, prefix_io)
            miss_ps, miss_counts = _store_wave(mods, srv, reqs[:1], label,
                                               f"{sname} miss and publish", cfg, quant)
            hit_ps, hit_counts = _store_wave(mods, srv, reqs[1:], label, f"{sname} hits", cfg,
                                             quant)
            flat = srv.metrics.counters_flat()
            got = [p.result.tokens[0].tolist() for p in miss_ps + hit_ps]
            entry = srv.prefix_store.lookup(prompts[1])
            bit, (s_err, kv_err) = _entry_vs_pieces(srv, entry, prompts[1], dev)
            run = {"cold_launches": cold_counts, "miss_publish_launches": miss_counts,
                   "hit_launches": hit_counts,
                   "counters": {k: flat.get(k, 0) for k in ("prefix_hits", "prefix_misses",
                                                            "prefix_publishes")},
                   "pieces_cold": _pieces_by_request(cold_srv, cold_ps),
                   "pieces_served": _pieces_by_request(srv, miss_ps + hit_ps),
                   "equal_cold": [g == c for g, c in zip(got, cold)],
                   "entry_bitwise_pieces": bit, "entry_s_max_rel": s_err,
                   "entry_kv_max_rel": kv_err, "publish_ms": pub_ms,
                   "entry_bytes": [a[2] for a in prefix_io if a[0] == "save"],
                   "entry_load_ms": [a[1] for a in prefix_io if a[0] == "load"]}
            res["launches"][f"prefix {sname} miss+publish"] = miss_counts
            res["launches"][f"prefix {sname} hits"] = hit_counts
            if sname == "greedy":  # the first token of request 0, hit against cold
                ttft = {"hit": [], "cold": []}
                first = DecodeRequest(prompts[0], 1, sample, seed=300)
                for _ in range(3):
                    for kind, s in (("hit", srv), ("cold", cold_srv)):
                        gc.collect()
                        pend = s.submit(first)
                        s.serve(drain_when_idle=True)
                        torch.cuda.synchronize()
                        if pend.result.tokens[0].tolist() != cold[0][:1]:
                            raise AssertionError(f"{label} stores: the timed request's token "
                                                 "moved")
                        ttft[kind].append((pend.done_at - pend.admitted_at) * 1e3)
                run["first_token_ms"] = {k: float(np.median(v)) for k, v in ttft.items()}
                run["first_token_ms_runs"] = ttft
            log(f"{label} stores, prefix {sname}: {run}")
            res["prefix"][sname] = run
            if run["counters"] != {"prefix_hits": 3, "prefix_misses": 1, "prefix_publishes": 1}:
                raise AssertionError(f"{label} stores: prefix counters {run['counters']}, want "
                                     "3 hits, 1 miss, 1 publish")
            if run["pieces_served"][1:] != [-(-n // SERVE_PIECE) for n in STORE_SUFFIXES[1:]]:
                raise AssertionError(f"{label} stores: a hit's pieces {run['pieces_served']} are "
                                     "not its suffix's")
            if not linear:  # the publish's swa is row 6, the pieces' plain: held as (f) was
                run["hit_gaps"] = {i: max(_forced_gaps(srv.engine.model, torch.from_numpy(
                    prompts[i]).to(dev), got[i])) for i, eq in enumerate(run["equal_cold"])
                    if not eq}
                log(f"{label} stores: hits whose greedy tokens differ from the cold request's, "
                    f"the one-row walk fed them, largest gap to its maximum (limit "
                    f"{LOGITS_ATOL}): {run['hit_gaps']}")
            if (linear and not all(run["equal_cold"])) or (s_err or 0) > LAYER_S_RTOL or (
                    kv_err or 0) > LAYER_KV_RTOL or any(
                    g > LOGITS_ATOL for g in run.get("hit_gaps", {}).values()):
                raise AssertionError(f"{label} stores: a prefix hit moved the tokens, or the "
                                     f"entry's state left (g)'s limits: {run}")
            if full and sname == "greedy":
                res["prefix"]["corrupt"] = _corrupt_check(mods, srv, reqs, cold, pdir, label,
                                                          cfg, quant)
            cold_srv.close()
            srv.close()
            del cold_srv, srv

        # (ii) durable sessions
        if linear:
            res["sessions"] = _sessions_check(mods, served, qmode, fp, prompts[1], samples,
                                              os.path.join(tmp, "sessions"), label, cfg, quant)
            for sname, r in res["sessions"]["runs"].items():
                res["launches"][f"session {sname}"] = r["launches"]
        # (iii) an outage
        if full:
            res["outage"] = _outage_check(mods, served, prompts, cold_by_sample["greedy"],
                                          samples["greedy"], tmp, label, cfg, quant)
            res["launches"]["outage"] = res["outage"]["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["part_s"] = time.perf_counter() - t_part
    log(f"{label} stores part took {res['part_s']:.1f} s ({card})")
    return res


def _corrupt_check(mods, srv, reqs, cold, pdir, label, cfg, quant):
    """A second generation of the entry with the latest corrupted: the hit
    falls back to the first (a warning), bitwise; every generation corrupted:
    a cold prefill, bitwise, no hit counted."""
    import warnings

    from orion_tpu_torch.resilience import inject

    store = srv.prefix_store
    row = reqs[0].prompt[:, :STORE_PREFIX]
    key = store.key_for(row)
    store.publish(row, store.lookup(reqs[1].prompt).state, skip_if_present=False)
    gens = store.generations(key)
    inject.corrupt_session(pdir, key)  # the newest generation
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ps, _ = _store_wave(mods, srv, reqs[1:2], label, "hit on a corrupt latest", cfg, quant)
        fell_back = srv.flight.events("prefix_hit")[-1]["generation"]
        hits = srv.metrics.counters_flat()["prefix_hits"]
        for g in gens[:-1]:  # the newest is corrupt already (a second flip would mend it)
            inject.corrupt_session(pdir, key, generation=g)
        ps2, _ = _store_wave(mods, srv, reqs[2:3], label, "every generation corrupt", cfg, quant)
    out = {"generations": gens, "fell_back_to": fell_back,
           "warnings": sum("corrupt" in str(x.message) for x in w),
           "hit_equal": ps[0].result.tokens[0].tolist() == cold[1],
           "cold_equal": ps2[0].result.tokens[0].tolist() == cold[2],
           "hit_counted_on_total_damage": srv.metrics.counters_flat()["prefix_hits"] - hits}
    log(f"{label} stores, corrupt entries: {out}")
    if not (gens == [1, 2] and fell_back == 1 and out["warnings"] and out["hit_equal"]
            and out["cold_equal"] and out["hit_counted_on_total_damage"] == 0):
        raise AssertionError(f"{label} stores: a corrupt entry did not fall back: {out}")
    return out


def _sessions_check(mods, served, qmode, fp, prompt, samples, sdir, label, cfg, quant):
    """Two turns of a session, the second suspended by a SIGTERM and resumed
    from disk by a fresh Server, against one uninterrupted request."""
    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.serving import DecodeRequest, Health, Server, SessionIdentityError

    empty = np.zeros((1, 0), np.int64)
    out = {"runs": {}}
    for sname, sample in samples.items():
        sid = f"conv-{sname}"
        ref_srv = Server(served, _server_config("inscan", qmode=qmode))
        (ref,), _ = _store_wave(mods, ref_srv, [DecodeRequest(prompt, 104, sample, seed=400)],
                                label, f"uninterrupted {sname}", cfg, quant)
        ref_srv.close()
        del ref_srv
        scfg = _server_config("inscan", qmode=qmode, session_dir=sdir)
        srv1 = Server(served, scfg)
        io = []
        _tap(srv1.session_store, io)
        (t1,), c1 = _store_wave(mods, srv1, [DecodeRequest(prompt, 40, sample, seed=400,
                                                           session_id=sid)],
                                label, f"session {sname} turn 1", cfg, quant)
        sig = inject.FaultPlan().preempt_at_chunk(srv1.engine._chunk_counter + 1)
        (t2a,), c2 = _store_wave(mods, srv1, [DecodeRequest(empty, 64, sample, session_id=sid)],
                                 label, f"session {sname} turn 2 until SIGTERM", cfg, quant,
                                 fault=sig, statuses=("suspended",), idle=False)
        if srv1.health.state is not Health.DEAD or not 0 < t2a.result.new_tokens < 64:
            raise AssertionError(f"{label} stores: the SIGTERM did not suspend turn 2 "
                                 f"mid-stream: {srv1.health.state}, {t2a.result.new_tokens}")
        size = os.path.getsize(os.path.join(
            sdir, sid, f"gen-{srv1.session_store.newest_generation(sid):06d}.bin"))
        del srv1
        srv2 = Server(served, scfg)  # a fresh Server and engine, the same weights
        _tap(srv2.session_store, io)
        (t2b,), c3 = _store_wave(mods, srv2, [DecodeRequest(
            empty, 64 - t2a.result.new_tokens, sample, session_id=sid)], label,
            f"session {sname} turn 2 resumed", cfg, quant)
        srv2.close()
        del srv2
        total = np.concatenate([t1.result.tokens, t2a.result.tokens, t2b.result.tokens], 1)
        r = {"equal": total[0].tolist() == ref.result.tokens[0].tolist(),
             "turns": [t1.result.new_tokens, t2a.result.new_tokens, t2b.result.new_tokens],
             "save_ms": [a[1] for a in io if a[0] == "save"],
             "load_ms": [a[1] for a in io if a[0] == "load"], "bytes": size,
             "launches": {k: c1[k] + c2[k] + c3[k] for k in c1}}
        log(f"{label} stores, session {sname}: {r}")
        if not r["equal"] or not r["load_ms"]:
            raise AssertionError(f"{label} stores: turns 1 + 2 through a restart moved the "
                                 f"tokens, or turn 2 was not read from disk: {r}")
        out["runs"][sname] = r
    if quant:  # a session saved at int4 is refused by a full-precision Server
        srv = Server(fp, _server_config("inscan", session_dir=sdir))
        pend = srv.submit(DecodeRequest(empty, 16, samples["greedy"],
                                        session_id="conv-greedy"))
        srv.serve(drain_when_idle=True)
        srv.close()
        out["cross_qmode_refused"] = isinstance(pend.error, SessionIdentityError)
        log(f"{label} stores: a bf16 Server's resume of an int4 session: {pend.error!r}")
        if not out["cross_qmode_refused"]:
            raise AssertionError(f"{label} stores: a cross-qmode resume was not refused")
    return out


def _outage_check(mods, served, prompts, cold, sample, tmp, label, cfg, quant):
    """Turn 2 of a session and a prefix hit under sustained "eio" regimes on
    the session save and the prefix load; recovery; turn 3."""
    import warnings

    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.resilience.retry import RetryPolicy
    from orion_tpu_torch.serving import DecodeRequest, Health, Server

    empty = np.zeros((1, 0), np.int64)
    sp = _serve_prompts(LM_PLAN, cfg.vocab_size)[2]
    ref_srv = Server(served, _server_config("inscan"))
    (ref,), _ = _store_wave(mods, ref_srv, [DecodeRequest(sp, 96, sample, seed=500)], label,
                            "outage's uninterrupted session", cfg, quant)
    ref_srv.close()
    reqs = [DecodeRequest(p, SERVE_NEW, sample, seed=300 + i, prefix_len=STORE_PREFIX)
            for i, p in enumerate(prompts)]
    srv = Server(served, _server_config(
        "inscan", max_inflight=8, session_dir=os.path.join(tmp, "o-sessions"),
        prefix_dir=os.path.join(tmp, "o-prefix"), breaker_failures=1, breaker_backoff=0.05,
        breaker_max_backoff=0.2))
    srv.session_store._retry = srv.prefix_store._retry = RetryPolicy(attempts=1)
    t1, c1 = _store_wave(mods, srv, [DecodeRequest(sp, 32, sample, seed=500, session_id="u"),
                                     reqs[0]], label, "outage turn 1", cfg, quant)
    plan = inject.FaultPlan()
    plan.degrade_site("serve.session_save", "eio")
    plan.degrade_site("serve.prefix_load", "eio")
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t2, c2 = _store_wave(mods, srv, [DecodeRequest(empty, 32, sample, session_id="u"),
                                         reqs[1]], label, "outage turn 2", cfg, quant,
                             fault=plan)
        mid = {"health": srv.health.state.value, "reason": srv.health.reason,
               "breakers": {n: b.state for n, b in srv._breakers.items()},
               "dirty": sorted(srv._dirty_sessions), "delivered": len(plan.delivered)}
        # the regime has ended (the plan disarmed): the probes close the
        # breakers and the dirty session lands
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and (
                srv._dirty_sessions or srv.health.state is not Health.SERVING
                or any(b.state != "closed" for b in srv._breakers.values())):
            time.sleep(0.05)
            srv.serve(drain_when_idle=True)
    recover_s = time.perf_counter() - t0
    t3, c3 = _store_wave(mods, srv, [DecodeRequest(empty, 32, sample, session_id="u"),
                                     reqs[2]], label, "outage turn 3", cfg, quant)
    flat = srv.metrics.counters_flat()
    total = np.concatenate([t1[0].result.tokens, t2[0].result.tokens, t3[0].result.tokens], 1)
    out = {"mid_outage": mid, "after": {"health": srv.health.state.value,
                                        "breakers": {n: b.state for n, b in srv._breakers.items()},
                                        "dirty": sorted(srv._dirty_sessions),
                                        "newest_generation": srv.session_store.newest_generation(
                                            "u")},
           "session_equal": total[0].tolist() == ref.result.tokens[0].tolist(),
           "prefix_equal": [t[1].result.tokens[0].tolist() == cold[i]
                            for i, t in enumerate((t1, t2, t3))],
           "failed": flat.get("failed", 0), "shed": flat.get("shed", 0),
           "breaker_trips": {n: sum(e["store"] == n and e["to"] == "open"
                                    for e in srv.flight.events("breaker"))
                             for n in srv._breakers}, "warnings": len(w),
           "outage_and_recovery_s": recover_s,
           "launches": {k: c1[k] + c2[k] + c3[k] for k in c1}}
    log(f"{label} stores, outage: {out}")
    srv.close()
    if not (out["session_equal"] and all(out["prefix_equal"]) and out["failed"] == 0
            and out["shed"] == 0 and mid["health"] == "degraded"
            and mid["reason"].startswith("store-outage:")
            and mid["breakers"]["session"] in ("open", "half_open") and mid["dirty"] == ["u"]
            and min(out["breaker_trips"].values()) >= 1
            and out["after"] == {"health": "serving", "breakers": {"prefix": "closed",
                                                                   "session": "closed"},
                                 "dirty": [], "newest_generation": 3}):
        raise AssertionError(f"{label} stores: the outage run misbehaved: {out}")
    return out


# the speculative part: depth 4, so a round's verify piece at 4 slots is 20
# rows, one block of DECODE_ROWS
SPEC_DEPTH = 4


def _q4_per_draft(cfg):
    """Int4 dense layers a draft step runs: those of the linear blocks."""
    mlp = 3 if cfg.mlp == "swiglu" else 2
    return sum(4 + (0 if cfg.moe_at(i) else mlp)
               for i, lt in enumerate(cfg.resolved_layer_types) if lt == "linear")


def _spec_want(cfg, stats, quant, slots=SERVE_SLOTS, depth=SPEC_DEPTH):
    """A speculative run's exact launches: rows 1 and 6 only in the
    admissions (as the plain run's), row 14 at int4 ``_q4_per_step`` a step
    of each unified boundary's chunk, and a round ``depth`` draft steps of
    ``_q4_per_draft`` plus ``_q4_per_step`` for each block of DECODE_ROWS
    rows of the verify piece."""
    from orion_tpu_torch.models.transformer import DECODE_ROWS

    lin, attn, _, _ = _layer_counts(cfg)
    blocks = -(-slots * (depth + 1) // DECODE_ROWS)
    want = dict.fromkeys(KERNELS, 0)
    want.update(causal_dot_norm_wgmma=lin * (stats["host_prefills"] + stats["unified"]),
                flash_fwd_wgmma=attn * stats["host_prefills"],
                q4_matmul_mma=(_q4_per_step(cfg) * SERVE_CHUNK * stats["unified"]
                               + stats["rounds"] * (depth * _q4_per_draft(cfg)
                                                    + _q4_per_step(cfg) * blocks)
                               if quant == "int4" else 0))
    return want


def spec_model_check(model, label, depth=SPEC_DEPTH, strict=True):
    """The verify piece at full width, 4 rows x P = depth + 1 fed tokens, the
    rows at different positions (past the 1024-key window for a swa model):
    its logits bitwise P successive ``decode_step`` calls;
    ``advance_verified_states`` at keep 0, 2 and P bitwise the walk of that
    many tokens, caches and rings included; every product of the piece and
    of a draft step at ``DECODE_ROWS`` rows (``product_rows``). ``strict``:
    raise when one of them fails."""
    from orion_tpu_torch.models.transformer import (DECODE_ROWS, linear_layer_indices,
                                                    snapshot_decode_state)
    from orion_tpu_torch.utils.row_probe import product_rows

    swa = "swa" in model.cfg.resolved_layer_types
    tok, states, t = _probe_batch(model, prompt_len=1100 if swa else 300)
    p = depth + 1
    rng = np.random.default_rng(12)
    fed = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (tok.shape[0], p))).to(
        tok.device)
    fed[:, 0] = tok
    out = {"keep": {}}
    with torch.inference_mode():
        st, walk, ref = snapshot_decode_state(states), [snapshot_decode_state(states)], []
        for j in range(p):
            lg, st = model.decode_step(fed[:, j], st, t + j)
            ref.append(lg)
            walk.append(snapshot_decode_state(st))
        ref = torch.stack(ref, dim=1)
        del st
        bitwise = []
        for keep in (0, 2, p):
            st = snapshot_decode_state(states)
            logits, upds = model.verify_step(fed, st, t)
            bitwise.append(bool(torch.equal(logits, ref)))
            out["logits_max_abs"] = float((logits - ref).abs().max())
            got = model.advance_verified_states(st, upds, t, torch.full_like(t, keep))
            out["keep"][keep] = all(torch.equal(x[k], y[k]) for x, y in zip(got, walk[keep])
                                    for k in x)
            del st, got, upds
        out["logits_bitwise"] = all(bitwise)
        lin = linear_layer_indices(model.cfg)
        rows = (product_rows(model.verify_step, fed, snapshot_decode_state(states), t)
                + product_rows(model.draft_step, tok, [states[i] for i in lin], t))
    out["product_rows"] = sorted({r for _, r, _ in rows})
    out["products"] = len(rows)
    del walk, states
    log(f"{label} speculation, the verify piece at 4 rows x {p}: logits bitwise {p} decode "
        f"steps: {out['logits_bitwise']} (largest difference {out['logits_max_abs']}); the "
        f"advance bitwise the walk at keep 0, 2, {p}: {out['keep']}; {out['products']} products "
        f"of the piece and a draft step at rows {out['product_rows']}")
    if strict and not (out["logits_bitwise"] and all(out["keep"].values())
                       and out["product_rows"] == [DECODE_ROWS]):
        raise AssertionError(f"{label}: the verify piece is not the decode walk: {out}")
    return out


def spec_times(model, plan, label, card, depths=(0, 2, SPEC_DEPTH), turns=2, steps=3):
    """Readings, not limits: decode ms/token at 4 busy slots (host
    admission, the plan's prompts cut to 256 tokens, 256 new) with
    speculation off and at each depth of ``depths``, in turns: a boundary's
    wall ms over the tokens it advanced a slot (16 for a plain chunk, the
    accepted drafts + 1 on average for a round), medians of ``steps``
    boundaries after one; a round's ms; the acceptance rate."""
    from orion_tpu_torch.generate import SampleConfig
    from orion_tpu_torch.serving import DecodeRequest

    greedy = SampleConfig(temperature=0.0)
    prompts = [p[:, :256] for p in _serve_prompts(plan, model.cfg.vocab_size)]
    out = {d: {"ms_per_token": [], "step_ms": [], "accepted": 0, "drafted": 0} for d in depths}
    for _ in range(turns):
        for d in depths:
            gc.collect()
            rounds = []
            eng = serve_engine(model, "host", spec_depth=d, spec_min_accept=0.0,
                               on_event=lambda k, f: rounds.append(f) if k == "spec_round"
                               else None)
            for j in range(SERVE_SLOTS):
                eng.admit(DecodeRequest(prompts[j % len(prompts)], 256, greedy, seed=900 + j),
                          tag=j)
            eng.step()  # warm-up
            per, ms = [], []
            for _ in range(steps):
                dt, _ = wall_ms(eng.step)
                advanced = sum(e["decode_tokens"] for e in eng.last_boundary) / SERVE_SLOTS
                per.append(dt / advanced)
                ms.append(dt)
            out[d]["ms_per_token"].append(float(np.median(per)))
            out[d]["step_ms"].append(float(np.median(ms)))
            out[d]["accepted"] += sum(f["accepted"] for f in rounds)
            out[d]["drafted"] += sum(f["accepted"] + f["rejected"] for f in rounds)
            del eng
    for d in depths:
        out[d]["accept_rate"] = (out[d]["accepted"] / out[d]["drafted"]
                                 if out[d]["drafted"] else None)
    log(f"{label} speculation readings ({card}): decode ms/token at 4 busy slots by depth (0: "
        f"plain chunks of {SERVE_CHUNK}), turns in order: "
        + "; ".join(f"depth {d}: {out[d]['ms_per_token']} (a boundary {out[d]['step_ms']} ms, "
                    f"acceptance {out[d]['accept_rate']})" for d in depths))
    return out


def spec_cli(config, card, n_prompts=4, prompt_len=200, device_args=(), timeout=600):
    """``python -m orion_tpu_torch.serving --config <config> --slots 4 --chunk
    16 --max-new-tokens 32 --temperature 0 --spec-depth 4`` in a subprocess
    on the card, the prompts on stdin: exit 0, every prompt served, the
    stats line naming the depth and a ``speculation:`` line."""
    rng = np.random.default_rng(13)
    text = "".join("".join(chr(c) for c in rng.integers(97, 123, prompt_len)) + "\n"
                   for _ in range(n_prompts))
    cmd = [sys.executable, "-m", "orion_tpu_torch.serving", "--config", config, "--slots",
           str(SERVE_SLOTS), "--chunk", str(SERVE_CHUNK), "--max-new-tokens", str(SERVE_NEW),
           "--temperature", "0", "--spec-depth", str(SPEC_DEPTH), *device_args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, input=text, capture_output=True, text=True, cwd=str(ROOT),
                          env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=timeout)
    wall = time.perf_counter() - t0
    err = proc.stderr.splitlines()
    stats = next((line for line in err if line.startswith("stats:")), None)
    spec = next((line for line in err if line.startswith("speculation:")), None)
    occ = next((line for line in err if line.startswith("slot occupancy:")), None)
    res = {"rc": proc.returncode, "wall_s": wall, "stats": stats, "speculation": spec,
           "occupancy": occ}
    log(f"serving CLI with --spec-depth {SPEC_DEPTH} ({config}, {card}): exit {proc.returncode} "
        f"in {wall:.1f} s wall; {stats}; {spec}; {occ}")
    if proc.returncode != 0 or stats is None or f"'ok': {n_prompts}" not in stats or \
            spec is None or f"spec-depth {SPEC_DEPTH}" not in (occ or "") or \
            len(proc.stdout.splitlines()) != n_prompts:
        raise AssertionError(f"the serving CLI with --spec-depth failed: rc {proc.returncode}; "
                             f"stderr tail {proc.stderr[-2000:]}")
    return res


def spec_check(dev, mods, model, plan, label, card, engine, quant="", full=False,
               mutant=False):
    """The speculative part (``SlotEngine(spec_depth=4)``, 4 slots, chunk 16,
    no floor): the model-level checks (``spec_model_check``); the plan served
    again for every (sampling, admission) pair of ``engine`` (the plain runs'
    tokens), each request bitwise the plain run's, with exact launches
    (``_spec_want``), every pure-decode boundary a round, and for an
    all-linear model (its draft is the whole model) every draft accepted.
    ``full``: the rewind rung on a mid-speculation slot (NaN in slot 0's
    rows at its chunk 1: every request bitwise), the plan through a
    ``Server`` with ``spec_depth=4`` (bitwise the engine's, its speculation
    section and counters consistent, one acceptance observation a
    request), the readings (``spec_times``) and the CLI (``spec_cli``, for
    a model with swa layers). ``mutant``: the same checks with the verify
    piece's products at its own row count (``verify_rows`` undone): which
    of them reject it is recorded, not failed."""
    from orion_tpu_torch.generate import SampleConfig
    from orion_tpu_torch.resilience import inject

    t_part = time.perf_counter()
    samples = {"greedy": SampleConfig(temperature=0.0), "sampled": SampleConfig(**SAMPLED_SERVE)}
    linear = all(lt == "linear" for lt in model.cfg.resolved_layer_types)
    out = {"model": spec_model_check(model, label), "launches": {}, "runs": {}}
    for (sname, mode), want_tokens in sorted(engine.items()):
        gc.collect()
        _reset_counts(mods)
        t0 = time.perf_counter()
        got, st = run_plan(model, plan, samples[sname], mode, spec_depth=SPEC_DEPTH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts(mods)
        want = _spec_want(model.cfg, st, quant)
        run = f"{sname} {mode}"
        equal = _tokens(got) == want_tokens
        rate = st["accepted"] / max(st["accepted"] + st["rejected"], 1)
        out["launches"][run] = counts
        out["runs"][run] = {"s": secs, "stats": st, "equal": equal, "accept_rate": rate}
        log(f"{label} speculation, {run}: {len(plan)} requests in {secs:.2f} s, {st}; acceptance "
            f"{rate:.4f}; launches {dict((k, v) for k, v in counts.items() if v)}; tokens bitwise "
            f"the plain run's: {equal}")
        if counts != want:
            raise AssertionError(f"{label} speculation {run} launched {counts}, want {want}")
        if not equal or any(r.status != "ok" for r in got.values()):
            raise AssertionError(f"{label} speculation {run}: tokens differ from the plain run's")
        if st["rounds"] != st["pure"] or not st["rounds"]:
            raise AssertionError(f"{label} speculation {run}: {st['rounds']} rounds at "
                                 f"{st['pure']} pure-decode boundaries")
        if linear and st["rejected"]:
            raise AssertionError(f"{label} speculation {run}: the all-linear model rejected "
                                 f"{st['rejected']} of its own drafts")
    if mutant:
        out["mutant"] = spec_mutant(model, plan, label, engine, samples)
    if full:
        greedy_host = engine[("greedy", "host")]
        fault = inject.FaultPlan().poison_decode_slot_at(0, chunk=1)
        got, st = run_plan(model, plan, samples["greedy"], "host", fault=fault,
                           spec_depth=SPEC_DEPTH)
        out["rewind"] = {"delivered": fault.delivered, "equal": _tokens(got) == greedy_host,
                         "rewinds": {i: r.rewinds for i, r in got.items() if r.rewinds},
                         "reprefills": sum(r.reprefills for r in got.values())}
        log(f"{label} speculation, NaN in slot 0's rows at its chunk 1 (a round): {out['rewind']}")
        if not (out["rewind"]["equal"] and out["rewind"]["rewinds"] == {0: 1}
                and not out["rewind"]["reprefills"]):
            raise AssertionError(f"{label} speculation: the rewind rung misbehaved: "
                                 f"{out['rewind']}")
        _reset_counts(mods)
        srv, ps, secs = server_plan(model, plan, samples["greedy"], "host",
                                    spec_depth=SPEC_DEPTH, spec_min_accept=0.0)
        counts = _counts(mods)
        snap = srv.snapshot()
        spec, flat = snap["speculation"], srv.metrics.counters_flat()
        hist = [h for h in snap["metrics"]["histograms"] if h["name"] == "spec_accept_rate"]
        stats = {"host_prefills": len(srv.flight.events("admit")), "unified": 0,
                 "rounds": srv.stats["chunks"]}
        want = _spec_want(model.cfg, stats, quant)
        got = {i: p.result.tokens[0].tolist() for i, p in enumerate(ps)}
        out["server"] = {"s": secs, "equal": got == greedy_host, "speculation": spec,
                         "accept_observations": hist[0]["count"] if hist else 0,
                         "launches": counts}
        out["launches"]["server greedy host"] = counts
        log(f"{label} speculation through the Server (spec_depth {SPEC_DEPTH}): {len(plan)} "
            f"requests in {secs:.2f} s, stats {srv.stats}; speculation section {spec}; "
            f"acceptance observations {out['server']['accept_observations']}; launches "
            f"{dict((k, v) for k, v in counts.items() if v)}; tokens bitwise the engine's: "
            f"{out['server']['equal']}")
        consistent = (spec["depth"] == SPEC_DEPTH
                      and spec["accepted_total"] == flat.get("spec_accepted_total", 0)
                      and spec["rejected_total"] == flat.get("spec_rejected_total", 0)
                      and spec["accepted_total"] + spec["rejected_total"] > 0
                      and spec["floors_total"] == 0
                      and out["server"]["accept_observations"] == len(plan)
                      and (not linear or spec["rejected_total"] == 0))
        if not (out["server"]["equal"] and srv.stats["ok"] == len(plan) and consistent):
            raise AssertionError(f"{label} speculation through the Server: {out['server']}")
        if counts != want:
            raise AssertionError(f"{label} speculation Server launched {counts}, want {want}")
        srv.close()
        del srv, ps
        out["times"] = spec_times(model, plan, label, card)
        if not linear:
            out["cli"] = spec_cli(model.cfg.name, card)
    out["part_s"] = time.perf_counter() - t_part
    log(f"{label} speculative part took {out['part_s']:.1f} s")
    return out


def spec_mutant(model, plan, label, engine, samples):
    """The fault the row count exists for: the verify piece's products at its
    own row count (20 rows at 4 slots) while a decode step's run at
    ``DECODE_ROWS``. -> which checks see it by the numbers: the piece's
    logits against the decode walk's, the advance against the walk, the
    greedy host run's tokens, the all-linear model's acceptance (the
    products' row count, which the model-level check also reads, names the
    fault on any device)."""
    from orion_tpu_torch.models import transformer

    saved = transformer.verify_rows
    transformer.verify_rows = lambda n: n
    try:
        m = spec_model_check(model, f"{label} (mutant: the piece at its own row count)",
                             strict=False)
        got, st = run_plan(model, plan, samples["greedy"], "host", spec_depth=SPEC_DEPTH)
    finally:
        transformer.verify_rows = saved
    res = {"logits_bitwise": m["logits_bitwise"], "logits_max_abs": m["logits_max_abs"],
           "advance_bitwise": all(m["keep"].values()), "product_rows": m["product_rows"],
           "tokens_differ": _tokens(got) != engine[("greedy", "host")],
           "rejected_drafts": st["rejected"], "rejecting_rounds": st["rejecting_rounds"],
           "rounds": st["rounds"]}
    res["rejected"] = bool(not m["logits_bitwise"] or not res["advance_bitwise"]
                           or res["tokens_differ"] or st["rejected"])
    log(f"{label} speculation mutant (the verify piece unpadded): {res}")
    return res


def serving_phase(dev, mods, name, plan, card, quant="", checks=("b", "f", "g", "ladder",
                                                                 "session", "times"),
                  server_runs=(), overrides=None):
    """``SlotEngine`` at ``name``'s full width (``quant``: quantized from the
    seeded fp32 weights; ``overrides``: a depth cut), chunk 16, pieces of 256. The main path: ``plan``
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
    ``session_check`` (``DecodeSession``); "spec" -- the speculative part
    (``spec_check``; "spec_full" and "spec_mutant" widen it). ``server_runs``: (sampling,
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

    cfg = get_config(name, **(overrides or {}))
    fp = TransformerLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    model = quantize_for_decode(fp, quant) if quant else cast_params_for_inference(fp)
    if not (quant and (server_runs or "stores" in checks)):
        fp = None  # else the Server quantizes the fp32 weights itself
    torch.cuda.empty_cache()
    cut = f" ({cfg.n_layers} blocks)" if overrides else ""
    label = f"{name}{' ' + quant if quant else ''}{cut} serving"
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
    if "stores" in checks:
        res["stores"] = stores_check(dev, mods, model, label, card, quant=quant, fp=fp,
                                     full="stores_full" in checks)
    if "spec" in checks:
        res["spec"] = spec_check(dev, mods, model, plan, label, card, engine_tokens, quant=quant,
                                 full="spec_full" in checks, mutant="spec_mutant" in checks)
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


# ---------------------------------------------------------------------------
# Sequence parallelism (A12 step 1): the kernel pieces, the sp bodies and sp
# training, with ranks as processes sharing the one card
# ---------------------------------------------------------------------------

# Rows 6-8 with the mask moved, as the sp rings call them (label, B, H, Tq,
# Tk, D, dtype, window, shift, q_offset): the striped ring's blocks at its
# per-step shape (T 8192 at sp 4) with shift 0 and 1, the halo's blocks at
# q_offset T_loc (h = 1: T_loc 2048, window 1024) and T_loc, 2 T_loc (h = 2:
# T_loc 512), ragged ones, a block whose every row is past the window, and
# the simt kernels' tiny fp32 widths. Held at the limits of rows 6-8
# (``FLASH_RTOL``, ``FLASH_ATOL_OF_MAX``, ``FLASH_GRAD_FLOOR``, ``LSE_RTOL``);
# a row that sees no key must give lse at or below the ring merge's guard
# (``SP_GUARD``) in both, and every output must be finite.
FLASH_SP_CASES = [
    ("striped block, shift 0", 2, 16, 2048, 2048, 128, torch.bfloat16, None, 0, 0),
    ("striped block, shift 1", 2, 16, 2048, 2048, 128, torch.bfloat16, None, 1, 0),
    ("halo h1, block 1", 2, 16, 2048, 2048, 128, torch.bfloat16, 1024, 0, 2048),
    ("halo h2, block 1", 4, 16, 512, 512, 128, torch.bfloat16, 1024, 0, 512),
    ("halo h2, block 2", 4, 16, 512, 512, 128, torch.bfloat16, 1024, 0, 1024),
    ("ragged strict", 2, 16, 1000, 1000, 128, torch.bfloat16, None, 1, 0),
    ("ragged halo", 2, 16, 1000, 1000, 128, torch.bfloat16, 512, 0, 1000),
    ("every row past the window", 1, 16, 256, 256, 128, torch.bfloat16, 128, 0, 512),
    ("tiny widths strict", 2, 4, 96, 96, 32, torch.float32, None, 1, 0),
    ("tiny widths halo, block 1", 2, 4, 96, 96, 32, torch.float32, 40, 0, 48),
    ("tiny widths halo, block 2", 2, 4, 96, 96, 32, torch.float32, 40, 0, 96),
]
SP_GUARD = -5e29  # parallel/ring.py's _lse_merge drops a block whose lse is at or below it


def compare_flash_sp(fa, dev):
    """Rows 6-8 at ``FLASH_SP_CASES`` against their plain versions on the
    card, delta with a random lse cotangent folded in (as the rings' merge
    gives it). Returns one reading per case and the inputs by label."""
    g = torch.Generator(device=dev).manual_seed(20)
    readings, inputs = [], {}
    for label, b, h, tq, tk, d, dtype, window, shift, q_offset in FLASH_SP_CASES:
        q, k, v, gout = _flash_inputs(g, dev, b, h, (tq, tk), d, dtype)
        opts = dict(causal=True, window=window, shift=shift, q_offset=q_offset)
        out, lse = fa.flash_fwd_cuda(q, k, v, **opts)
        r_out, r_lse = fa.flash_fwd_plain(q, k, v, **opts)
        dlse = torch.randn(q.shape[0], tq, 1, device=dev, generator=g)
        delta = (gout.float() * r_out.float()).sum(-1, keepdim=True) - dlse
        dq = fa.flash_dq_cuda(q, k, v, gout, r_lse, delta, **opts)
        dk, dv = fa.flash_dkv_cuda(q, k, v, gout, r_lse, delta, **opts)
        torch.cuda.synchronize()
        r_dq = fa.flash_dq_plain(q, k, v, gout, r_lse, delta, **opts)
        r_dk, r_dv = fa.flash_dkv_plain(q, k, v, gout, r_lse, delta, **opts)
        mask = fa._mask(tq, tk, True, window, dev, shift, q_offset)
        empty = ~mask.any(dim=-1)
        rtol = FLASH_RTOL[dtype]
        lse_diff = (lse - r_lse).abs()
        readings.append({
            "case": f"{label}: B{b} H{h} Tq{tq} Tk{tk} D{d} {str(dtype)[6:]} window={window} "
                    f"shift={shift} q_offset={q_offset}",
            "fwd_variant": fa.flash_fwd_variant(q, k, v),
            "variant": fa.flash_bwd_variant(q, k, v, gout),
            "out": _grad_reading(out, r_out, rtol, FLASH_ATOL_OF_MAX),
            "dq": _grad_reading(dq, r_dq, rtol, FLASH_ATOL_OF_MAX, FLASH_GRAD_FLOOR),
            "dk": _grad_reading(dk, r_dk, rtol, FLASH_ATOL_OF_MAX, FLASH_GRAD_FLOOR),
            "dv": _grad_reading(dv, r_dv, rtol, FLASH_ATOL_OF_MAX, FLASH_GRAD_FLOOR),
            "lse_max_abs": float(lse_diff.max()),
            "lse_over_limit": float((lse_diff / (LSE_RTOL * r_lse.abs().clamp_min(1.0))).max()),
            "lse_well_formed": lse.shape == (q.shape[0], tq, 1) and lse.dtype == torch.float32
            and bool(torch.isfinite(lse).all()),
            "empty_rows": int(empty.sum()),
            # the guard on both sides, and the kernel's out 0 there
            "empty_ok": bool((lse[:, empty] <= SP_GUARD).all() and (r_lse[:, empty] <= SP_GUARD).all()
                             and (out[:, empty] == 0).all()),
            "pairs": q.shape[0] * int(mask.sum()),
        })
        inputs[label] = (b, h, q, k, v, gout, r_lse, delta, opts, readings[-1]["pairs"])
        del out, lse, r_out, dq, dk, dv, r_dq, r_dk, r_dv
    return readings, inputs


def agrees_flash_sp(r):
    return agrees_flash(r) and r["empty_ok"]


# linear_attention_parts (rows 1, 3 and 4 behind LinearAttentionPartsFn) at
# lm_1b3's width on one rank's shard of T 8192 at sp 4, without and with an
# initial state, and the tiny fp32 widths. Values at row 1's training
# outputs' limit (num, den, S, z within ``STATE_RTOL`` of their largest
# magnitude), the gradients for cotangents on all four outputs at rows 3
# and 4's (``GRAD_RTOL``, ``GRAD_ATOL_OF_MAX``), against autograd of the
# plain version. The numerator's cotangent is drawn on bf16's grid, so the
# Function's cast of it to the input dtype (``_lin_attn_fused_raw_bwd``'s)
# is exact and both sides take the same values.
PARTS_CASES = [
    ("lm_1b3 shard: B4 H16 T2048 D128 bf16", 4, 16, 2048, 128, torch.bfloat16, False),
    ("B4 H16 T1000 D128 bf16 state", 4, 16, 1000, 128, torch.bfloat16, True),
    ("tiny widths: B2 H4 T300 D32 fp32 state", 2, 4, 300, 32, torch.float32, True),
]


def compare_parts(cd, dev):
    g = torch.Generator(device=dev).manual_seed(21)
    readings, inputs = [], {}
    for label, b, h, t, d, dtype, with_state in PARTS_CASES:
        randn = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
        q, k = (torch.nn.functional.elu(randn(b, h, t, d)).add(1.0).to(dtype) for _ in range(2))
        v = randn(b, h, t, d).to(dtype)
        state = (randn(b, h, d, d), randn(b, h, d).abs() + 1.0) if with_state else None
        cts = [randn(b, h, t, d).to(dtype).float(), randn(b, h, t) / t, randn(b, h, d, d),
               randn(b, h, d)]
        res = {}
        for backend in ("cuda", "torch"):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            st = tuple(s.clone().requires_grad_() for s in state) if state else None
            num, den, (s, z) = cd.linear_attention_parts(*leaves, initial_state=st,
                                                         backend=backend)
            sum((o * c).sum() for o, c in zip((num, den, s, z), cts)).backward()
            res[backend] = [num.detach(), den.detach(), s.detach(), z.detach(),
                            *(x.grad for x in leaves), *((x.grad for x in st) if st else ())]
        got, ref = res["cuda"], res["torch"]
        torch.cuda.synchronize()
        readings.append({
            "case": label, "variant": cd.causal_dot_norm_variant(q.view(-1, t, d), k.view(-1, t, d),
                                                                 v.view(-1, t, d)),
            **{f"{n}_rel": _rel(a, r) for n, a, r in zip(("num", "den", "s", "z"), got, ref)},
            **{n: _grad_reading(a, r) for n, a, r in zip(("dq", "dk", "dv"), got[4:7], ref[4:7])},
            **({f"{n}_rel": _rel(a, r) for n, a, r in zip(("ds0", "dz0"), got[7:], ref[7:])}
               if state else {}),
            "finite": all(bool(torch.isfinite(x.float()).all()) for x in got),
        })
        inputs[label] = (q, k, v, cts)
    return readings, inputs


def agrees_parts(r):
    rels = [v for key, v in r.items() if key.endswith("_rel")]
    return (r["finite"] and max(rels) <= STATE_RTOL
            and all(r[n]["well_formed"] and r[n]["over_limit"] <= 1.0 for n in ("dq", "dk", "dv")))


def _parts_bound(q, v):
    """The parts function's forward and backward: rows 1 (with its training
    outputs), 3 and 4 on these inputs."""
    qf, vf = q.view(-1, *q.shape[-2:]), v.view(-1, *v.shape[-2:])
    parts = (_norm_bound(qf, vf, True), _bwd_bound(qf, vf, False), _bwd_bound(qf, vf, True))
    moved, flops = sum(p[0] for p in parts), sum(p[1] for p in parts)
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    return moved, flops, _bound(moved, flops, peak)


def check_sp_kernels(cd, fa, dev):
    """The kernel pieces of the sp path on the card: rows 6-8 with shift and
    q_offset (``compare_flash_sp``) and the raw fused parts of rows 1, 3, 4
    (``compare_parts``), each reading logged, both variants run; then timed
    where each variant's sp path takes it (the wgmma kernels at the striped
    ring's block, shift 1; the simt ones at the tiny fp32 halo block; the
    parts at lm_1b3's shard). Returns the kernels line's sp entries (their
    launches filled in by the sp training runs)."""
    readings, inputs = compare_flash_sp(fa, dev)
    for r in readings:
        log(f"flash sp {r['case']} (forward {r['fwd_variant']}, backward {r['variant']}; "
            f"{r['empty_rows']} rows see no key, guard and out 0 held: {r['empty_ok']}): "
            + "; ".join(f"{n} max abs {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3f} of its "
                        f"limit)" for n in ("out", "dq", "dk", "dv"))
            + f"; lse max abs {r['lse_max_abs']:.3e} ({r['lse_over_limit']:.3f} of its limit)")
    bad = [r for r in readings if not agrees_flash_sp(r)]
    if bad:
        raise AssertionError(f"a flash kernel with shift / q_offset disagrees: {bad}")
    ran = {v: sum(r["variant"] == v for r in readings) for v in ("wgmma", "simt")}
    if not all(ran.values()) or not any(r["empty_rows"] for r in readings):
        raise AssertionError(f"an sp flash variant ran on no case, or no case had empty rows: {ran}")
    parts, parts_inputs = compare_parts(cd, dev)
    for r in parts:
        log(f"linear_attention_parts {r['case']} (row 1 {r['variant']}): rel "
            + ", ".join(f"{k[:-4]} {v:.2e}" for k, v in r.items() if k.endswith("_rel"))
            + f" (limit {STATE_RTOL:g}); " + "; ".join(
                f"{n} max abs {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3f} of its limit)"
                for n in ("dq", "dk", "dv")))
    if not all(agrees_parts(r) for r in parts) or {r["variant"] for r in parts} != {"wgmma", "simt"}:
        raise AssertionError(f"linear_attention_parts disagrees with its plain version: {parts}")
    lines = []
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        for variant, label in (("wgmma", "striped block, shift 1"),
                               ("simt", "tiny widths halo, block 1")):
            b, h, q, k, v, gout, lse, delta, opts, pairs = inputs[label]
            bh, t, d = q.shape
            peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
            act = q.numel() * q.element_size()
            q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
            mask = fa._mask(t, t, True, opts["window"], dev, opts["shift"], opts["q_offset"])
            rows = {
                "fwd": dict(ms=cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, **opts), 10),
                            plain_ms=cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, **opts), 2),
                            library_ms=cuda_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask), 10),
                            moved=4 * act + bh * t * 4, flops=4 * d * pairs),
                "dq": dict(ms=cuda_ms(lambda: fa.flash_dq_cuda(q, k, v, gout, lse, delta, **opts),
                                      10),
                           plain_ms=cuda_ms(lambda: fa.flash_dq_plain(q, k, v, gout, lse, delta,
                                                                      **opts), 2),
                           moved=5 * act + 2 * bh * t * 4, flops=6 * d * pairs),
                "dkv": dict(ms=cuda_ms(lambda: fa.flash_dkv_cuda(q, k, v, gout, lse, delta,
                                                                 **opts), 10),
                            plain_ms=cuda_ms(lambda: fa.flash_dkv_plain(q, k, v, gout, lse, delta,
                                                                        **opts), 2),
                            moved=6 * act + 2 * bh * t * 4, flops=8 * d * pairs),
            }
            with torch.enable_grad():
                qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
                o = sdpa(qg, kg, vg, attn_mask=mask)
                bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), gout.view_as(o),
                                                             retain_graph=True), 10)
            for part, x in rows.items():
                x.setdefault("library_ms", bwd_ms)
                x["bound_ms"], x["bound_by"] = _bound(x["moved"], x["flops"], peak)
                x["shape"] = (f"{label}: B{b} H{h} T{t} D{d} {str(q.dtype)[6:]} "
                              f"window={opts['window']} shift={opts['shift']} "
                              f"q_offset={opts['q_offset']}")
                log(f"flash {part} {variant} sp timing {x['shape']}: kernel {x['ms']:.4f} ms, plain "
                    f"{x['plain_ms']:.4f} ms, bound {x['bound_ms']:.4f} ms by {x['bound_by']} "
                    f"({pairs / 1e6:.2f} M pairs); scaled_dot_product_attention under the same "
                    f"mask {x['library_ms']:.4f} ms" + (" (its backward, one call)"
                                                         if part != "fwd" else ""))
                names = ("out",) if part == "fwd" else ("dq",) if part == "dq" else ("dk", "dv")
                lines.append({
                    "name": f"flash_{part}_{variant}_sp", "route": "cuda",
                    "source": "orion_tpu_torch/csrc/flash_attention"
                              + ("" if part == "fwd" else "_bwd") + ".cu",
                    "replaces": "orion_tpu/ops/pallas/flash_attention.py"
                                + {"fwd": ":211", "dq": ":384", "dkv": ":418"}[part],
                    "max_abs_err": max(r[n]["max_abs"] for r in readings if r["variant"] == variant
                                       for n in names),
                    "over_limit": max(r[n]["over_limit"] for r in readings
                                      if r["variant"] == variant for n in names),
                    **{key: x[key] for key in keys}})
    for variant, label in (("wgmma", PARTS_CASES[0][0]), ("simt", PARTS_CASES[-1][0])):
        q, k, v, cts = parts_inputs[label]

        def fwd_bwd(backend):
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            num, den, (s, z) = cd.linear_attention_parts(*leaves, backend=backend)
            torch.autograd.backward((num, den, s, z), cts)

        moved, flops, (bound_ms, bound_by) = _parts_bound(q, v)
        x = dict(ms=cuda_ms(lambda: fwd_bwd("cuda"), 10), plain_ms=cuda_ms(lambda: fwd_bwd("torch"), 2),
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                 shape=f"{label}, forward + backward")
        log(f"linear_attention_parts {variant} timing {x['shape']}: kernels {x['ms']:.4f} ms, plain "
            f"{x['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} (rows 1, 3, 4: "
            f"{moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); library_ms: none")
        lines.append({
            "name": f"causal_dot_parts_{variant}", "route": "cuda",
            # row 1's source; rows 3 and 4 (its backward) are in the second
            "source": "orion_tpu_torch/csrc/causal_dot_norm.cu",
            "sources": ["orion_tpu_torch/csrc/causal_dot_norm.cu",
                        "orion_tpu_torch/csrc/causal_dot_bwd.cu"],
            "replaces": "orion_tpu/ops/pallas/causal_dot.py:629",
            "max_abs_err": max(r[n]["max_abs"] for r in parts if r["variant"] == variant
                               for n in ("dq", "dk", "dv")),
            **x})
    del inputs, parts_inputs
    torch.cuda.empty_cache()
    return lines


# The sp bodies against single-device kernel attention on the whole sequence,
# at lm_1b3 / hybrid_1b3's head widths (16 heads, D 128, bf16, window 1024),
# global T 8192 (T_loc 4096 at sp 2, 2048 at sp 4: one halo block) and T 2048
# at sp 4 (T_loc 512: the halo's h = 2). Limits: out and the gradients of q, k,
# v within SP_RTOL |ref| + SP_ATOL_OF_MAX max|ref|: each flash block's output
# is rounded to bf16 before the fp32 merge and the merged output once more
# (the reference rounds once), and a gradient sums up to sp + 1 bf16 block
# contributions in bf16 (autograd's accumulation), each off by up to half a
# bf16 step of its own size, which may be as large as max|ref| where they
# cancel: two bf16 steps relative, and 2^-7 of the largest element absolute.
SP_BODY_RUNS = ((2, 8192), (4, 8192), (4, 2048))
SP_RTOL, SP_ATOL_OF_MAX = 2**-6, 2**-7


def _sp_body_reading(got, ref):
    return _grad_reading(got, ref, SP_RTOL, SP_ATOL_OF_MAX)


def sp_bodies_rank(mesh, payload):
    """One rank of an sp-bodies run: the three bodies forward and backward on
    this rank's shard of global q, k, v [1, 16, T, 128] bf16 drawn on the
    card from one seed, against the single-device kernel attention of the
    whole sequence (computed on each rank) -> readings and times."""
    from orion_tpu_torch.ops.kernels import causal_dot as cd, flash_attention as fa
    from orion_tpu_torch.ops.linear_attention import linear_attention
    from orion_tpu_torch.parallel.ring import ring_attention_local, swa_halo_attention_local
    from orion_tpu_torch.parallel.sequence import sp_linear_attention_local

    for mod, key, path in payload.get("sources", ()):  # kernel_mutants.py's wrong copies
        {"cd": cd, "fa": fa}[mod].SOURCES[key] = Path(path)
    dev, group, t = mesh.device, mesh.sp_group, payload["t"]
    window, heads, d = payload["window"], payload.get("heads", 16), payload.get("d", 128)
    g = torch.Generator(device=dev).manual_seed(payload["seed"])
    randn = lambda: torch.randn(1, heads, t, d, device=dev, generator=g)  # noqa: E731
    q, k, v, w = randn(), randn(), randn(), randn()
    phi = lambda x: (torch.nn.functional.elu(x) + 1.0).to(torch.bfloat16)  # noqa: E731
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    bodies = {
        "sp_linear_attention (parts)": (
            lambda a, b, c: sp_linear_attention_local(a, b, c, group),
            lambda a, b, c: linear_attention(a, b, c), (phi(q), phi(k), v)),
        "striped ring, flash blocks": (
            lambda a, b, c: ring_attention_local(a, b, c, group, striped=True),
            lambda a, b, c: fa.flash_attention(a, b, c, causal=True), (q, k, v)),
        f"swa halo (window {window})": (
            lambda a, b, c: swa_halo_attention_local(a, b, c, group, window=window),
            lambda a, b, c: fa.flash_attention(a, b, c, causal=True, window=window), (q, k, v)),
    }
    out = {}
    for name, (body, ref_fn, (a, b, c)) in bodies.items():
        res, ms = {}, {}
        for side, fn, shard in (("sp", body, True), ("ref", ref_fn, False)):
            xs = [(mesh.shard(x, dim=2) if shard else x).detach().contiguous().requires_grad_()
                  for x in (a, b, c)]
            wt = mesh.shard(w, dim=2) if shard else w
            def run(fn=fn, xs=xs, wt=wt):
                y = fn(*xs)
                (y.float() * wt).sum().backward()
                return y.detach()

            ms[side], y = _timed(run, dev)
            res[side] = [y] + [x.grad for x in xs]
        ref = [mesh.shard(r, dim=2) for r in res["ref"]]
        out[name] = {n: _sp_body_reading(got, r) for n, got, r in
                     zip(("out", "dq", "dk", "dv"), res["sp"], ref)}
        out[name]["ms"] = ms  # the first call of each: build and warm-up included
        del res, ref
    torch.cuda.empty_cache()
    return out


def _timed(fn, dev):
    """(ms, fn()) by the host's clock, the card synchronized around it."""
    if dev.type == "cuda":
        return wall_ms(fn)
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def agrees_sp_body(r):
    return all(r[n]["well_formed"] and r[n]["over_limit"] <= 1.0 for n in ("out", "dq", "dk", "dv"))


def sp_spawn(world, fn, payload, timeout=600, mesh=None):
    """``fn(mesh, payload)`` on ``world`` ranks, processes of this script
    sharing the one card (``parallel.init_distributed`` picks gloo: the
    ranks outnumber the cards), on the mesh ``mesh`` (a ``MeshConfig``;
    default sp over every rank) -> their results in rank order. A rank that
    fails fails the call with its traceback; ranks that outlive
    ``timeout`` are killed and the call fails."""
    import queue
    import socket

    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_sp_entry, args=(r, world, port, fn, payload, out, mesh))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in range(world) if r not in results and procs[r].exitcode is not None]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"sp ranks {dead or 'all'} of {world} ended without a result "
                                       f"or outlived {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"sp rank {rank} of {world} failed:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def _sp_entry(rank, world, port, fn, payload, out, mesh_cfg=None):
    import traceback

    import torch.distributed as dist

    try:
        from orion_tpu_torch.parallel.mesh import MeshConfig, init_distributed

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mesh = init_distributed(mesh_cfg or MeshConfig(dp=1, sp=world),
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world, local_rank=rank,
                                local_world_size=world, device=payload.get("device"))
        res = fn(mesh, payload)
        dist.barrier()  # every rank's collectives are done before any leaves
        out.put((rank, True, res))
    except BaseException:  # noqa: BLE001 -- the traceback goes to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# sp training: full width (d_model 2048, 16 heads, vocab 32000, window 1024),
# T 2048, a global batch of 2, 2 steps at sp 4 against the sp=1 twin from the
# same seed and batches. Depth cut to 4 blocks, the first 2 recomputed in the
# backward (remat_skip 2: the collectives rerun inside the backward), so four
# ranks' AdamW state fits the one card beside each other. Step 1's lr is the
# peak (warmup 1: step 0's lr is 0, as optax's). Limits: a probe of the first
# batch's loss and every parameter's gradient, the grad check's
# (``LM_LOSS_ATOL``, ``LM_GRAD_REL_L2``: the sp path rounds each block's
# attention to bf16 in other places); each step's loss within
# ``LM_LOSS_ATOL`` and grad norm within ``LM_GRAD_REL_L2`` relative; after the
# steps, the share of parameter elements whose update (p - p_0) has the
# twin's sign at least ``SP_UPDATE_AGREE``: AdamW normalizes each element, so
# an element whose gradient is near zero takes a sign from bf16 noise, and a
# wrong gradient agrees on about half. The tiny fp32 hybrid (the simt kernels'
# path, T 256, window 16) within ``TINY_LOSS_ATOL`` and 1e-4 relative L2.
SP_TRAIN_RUNS = (
    ("lm_1b3", {"n_layers": 4, "remat_skip": 2}),
    ("hybrid_1b3", {"n_layers": 4, "remat_skip": 2,
                    "layer_types": ("swa", "softmax", "swa", "linear"), "ring_striped": True}),
)
SP_TRAIN = dict(steps=2, batch_size=2, seq_len=2048, warmup_steps=1)
SP_TINY = dict(steps=2, batch_size=2, seq_len=256, warmup_steps=1)
SP_UPDATE_AGREE = 0.95
SP_TINY_GRAD_REL_L2 = 1e-4


def sp_expected_launches(cfg, rank, sp, t_loc):
    """The launches of one sp training step on ``rank``: rows 1, 3 and 4
    once a linear layer (row 1 twice when recomputed); the striped ring's sp
    flash calls (forward twice when recomputed), ``shift`` 1 on the steps
    whose block comes from a later rank; the halo's local call and its blocks
    m <= min(rank, h) at ``q_offset``."""
    first_remat = cfg.n_layers - max(0, cfg.remat_skip) if cfg.remat else 0
    want = dict.fromkeys(("parts_fwd", "parts_dq", "parts_rev", "fwd", "dq", "dkv", "fwd_sp",
                          "dq_sp", "dkv_sp"), 0)
    for i, lt in enumerate(cfg.resolved_layer_types):
        again = 2 if i < first_remat else 1
        if lt == "linear":
            want["parts_fwd"] += again
            want["parts_dq"] += 1
            want["parts_rev"] += 1
            continue
        if lt == "softmax":  # striped: one call a step, shift 1 on the last sp - 1 - rank
            calls, offset = sp, sp - 1 - rank
        else:
            h = min(-(-(cfg.window - 1) // t_loc), sp - 1)
            calls, offset = 1 + min(rank, h), min(rank, h)
        want["fwd"] += again * calls
        want["dq"] += calls
        want["dkv"] += calls
        want["fwd_sp"] += again * offset
        want["dq_sp"] += offset
        want["dkv_sp"] += offset
    return want


def _sp_counts(cd, fa):
    return {"parts_fwd": cd.launches, "parts_dq": cd.launches_dq, "parts_rev": cd.launches_rev,
            "fwd": fa.launches_fwd, "dq": fa.launches_dq, "dkv": fa.launches_dkv,
            "fwd_sp": fa.launches_fwd_sp, "dq_sp": fa.launches_dq_sp, "dkv_sp": fa.launches_dkv_sp,
            "wgmma": cd.launches_wgmma + fa.launches_fwd_wgmma + fa.launches_dq_wgmma
            + fa.launches_dkv_wgmma + cd.launches_dq_wgmma + cd.launches_rev_wgmma,
            "simt": cd.launches_simt + fa.launches_fwd_simt + fa.launches_dq_simt
            + fa.launches_dkv_simt + cd.launches_dq_simt + cd.launches_rev_simt}


def _sp_reset(cd, fa):
    cd.launches = cd.launches_dq = cd.launches_rev = 0
    cd.launches_wgmma = cd.launches_simt = cd.launches_dq_wgmma = cd.launches_dq_simt = 0
    cd.launches_rev_wgmma = cd.launches_rev_simt = 0
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    fa.launches_fwd_wgmma = fa.launches_fwd_simt = 0
    fa.launches_dq_wgmma = fa.launches_dq_simt = fa.launches_dkv_wgmma = fa.launches_dkv_simt = 0
    fa.launches_fwd_sp = fa.launches_dq_sp = fa.launches_dkv_sp = 0


def _train_probe(trainer, batch):
    """The first batch's loss and every parameter's gradient (summed over
    the sp group), then the gradients cleared."""
    loss = float(trainer._loss_and_grads(batch, 0))
    grads = {n: (p.grad.float().clone() if p.grad is not None else torch.zeros_like(p))
             for n, p in trainer.params.items()}
    for p in trainer.params.values():
        p.grad = None
    return loss, grads


def sp_train_rank(mesh, payload):
    """One rank of the sp training runs: for each run, the Trainer at sp on
    this rank (the probe, then the steps, each with its launch counts against
    ``sp_expected_launches``); rank 0 then runs the sp=1 twin and compares.
    -> per run: losses, grad norms, launches, peak memory, and (rank 0) the
    readings against the twin."""
    from orion_tpu_torch.models.configs import TINY, get_config
    from orion_tpu_torch.ops.kernels import causal_dot as cd, flash_attention as fa
    from orion_tpu_torch.training.data import DataLoader, SyntheticDataset
    from orion_tpu_torch.training.trainer import MeshConfig, TrainConfig, Trainer

    dev = mesh.device
    results = {}
    runs = list(payload.get("runs", SP_TRAIN_RUNS)) + [("tiny hybrid fp32", None)]
    for name, over in runs:
        if over is None:  # the simt kernels' path
            model = dataclasses.replace(TINY, n_layers=4, layer_types=("swa", "softmax", "swa",
                                                                       "linear"),
                                        window=16, ring_striped=True, sequence_parallel=True)
            kw = SP_TINY
        else:
            model = get_config(name, sequence_parallel=True, **over)
            kw = payload.get("train", SP_TRAIN)
        cfg = TrainConfig(model=model, mesh=MeshConfig(dp=1, sp=mesh.sp), **kw)
        loader = DataLoader(SyntheticDataset(model.vocab_size, cfg.seq_len), cfg.batch_size,
                            seed=cfg.seed, device=dev)
        batches = [next(loader) for _ in range(cfg.steps)]
        loader.close()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        gc.collect()
        trainer = Trainer(cfg, mesh=mesh)
        p0 = {n: p.detach().float().clone() for n, p in trainer.params.items()} if mesh.is_main \
            else None
        probe = _train_probe(trainer, batches[0])
        want = sp_expected_launches(model, mesh.sp_rank, mesh.sp, cfg.seq_len // mesh.sp)
        steps, per_step = [], []
        for batch in batches:
            _sp_reset(cd, fa)
            ms, m = _timed(lambda: trainer.step(batch), dev)
            per_step.append(_sp_counts(cd, fa))
            steps.append({"ms": ms, "loss": m["loss"], "grad_norm": m["grad_norm"], "lr": m["lr"]})
        res = {"steps": steps, "per_step": per_step, "want": want,
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
               else 0.0,
               "transport": mesh.transport}
        if mesh.is_main:
            after = {n: p.detach().float().clone() for n, p in trainer.params.items()}
        del trainer
        torch.cuda.empty_cache()
        mesh.barrier()  # the other ranks wait while rank 0 runs the twin
        if mesh.is_main:
            res["twin"] = _sp_twin(cfg, batches, probe, p0, after, over is None, dev)
            del p0, after
            torch.cuda.empty_cache()
        mesh.barrier()
        results[name] = res
    return results


def _sp_twin(cfg, batches, probe, p0, after, tiny, dev):
    """The sp=1 twin of ``cfg`` on this rank's card from the same seed and
    batches, and the sp run's readings against it."""
    from orion_tpu_torch.training.trainer import MeshConfig, Trainer

    twin = Trainer(dataclasses.replace(cfg, mesh=MeshConfig(dp=1)), device=dev)
    t_loss, t_grads = _train_probe(twin, batches[0])
    loss, grads = probe
    rel = {n: float((g - t_grads[n]).norm() / t_grads[n].norm().clamp_min(1e-30))
           for n, g in grads.items()}
    steps = [twin.step(b) for b in batches]
    agree = total = 0
    for n, p in twin.params.items():
        du_sp, du = after[n] - p0[n], p.detach().float() - p0[n]
        agree += int((torch.sign(du_sp) == torch.sign(du)).sum())
        total += du.numel()
    del twin
    worst = max(rel.items(), key=lambda kv: kv[1])
    return {"probe_loss": loss, "twin_probe_loss": t_loss, "grad_rel_l2_max": worst[1],
            "grad_worst": worst[0], "twin_losses": [s["loss"] for s in steps],
            "twin_grad_norms": [s["grad_norm"] for s in steps],
            "update_sign_agree": agree / total, "tiny": tiny}


def sp_train_verdict(name, ranks):
    """Log the sp run's readings; raise where a limit is missed or a launch
    count is off."""
    twin = ranks[0]["twin"]
    tiny = twin["tiny"]
    loss_atol = TINY_LOSS_ATOL if tiny else LM_LOSS_ATOL
    grad_lim = SP_TINY_GRAD_REL_L2 if tiny else LM_GRAD_REL_L2
    losses = [s["loss"] for s in ranks[0]["steps"]]
    norms = [s["grad_norm"] for s in ranks[0]["steps"]]
    log(f"sp train {name} at sp {len(ranks)} (transport {ranks[0]['transport']}): probe loss "
        f"{twin['probe_loss']:.6f} vs the sp=1 twin's {twin['twin_probe_loss']:.6f}; gradients' "
        f"largest relative L2 error {twin['grad_rel_l2_max']:.3e} ({twin['grad_worst']}; limit "
        f"{grad_lim:g}); step losses {losses} vs {twin['twin_losses']} (limit {loss_atol:g}); "
        f"grad norms {norms} vs {twin['twin_grad_norms']}; update signs agree on "
        f"{twin['update_sign_agree']:.4f} of the elements (limit {SP_UPDATE_AGREE}); step ms "
        f"{[round(s['ms'], 1) for s in ranks[0]['steps']]}; peak memory a rank "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB")
    for r, res in enumerate(ranks):
        if any(c[k] != v for c in res["per_step"] for k, v in res["want"].items()):
            raise AssertionError(f"sp {name} rank {r}: launches {res['per_step']}, want "
                                 f"{res['want']} a step")
        kinds = {"wgmma": sum(c["wgmma"] for c in res["per_step"]),
                 "simt": sum(c["simt"] for c in res["per_step"])}
        if kinds["simt" if not tiny else "wgmma"]:
            raise AssertionError(f"sp {name} rank {r} took the other variant: {kinds}")
    rank_losses = {tuple(round(s["loss"], 9) for s in res["steps"]) for res in ranks}
    missed = (abs(twin["probe_loss"] - twin["twin_probe_loss"]) > loss_atol
              or twin["grad_rel_l2_max"] > grad_lim
              or any(abs(a - b) > loss_atol for a, b in zip(losses, twin["twin_losses"]))
              or any(abs(a - b) > grad_lim * b for a, b in zip(norms, twin["twin_grad_norms"]))
              or twin["update_sign_agree"] < SP_UPDATE_AGREE or len(rank_losses) != 1
              or not all(np.isfinite(x) for x in losses))
    if missed:
        raise AssertionError(f"sp training {name} misses its limits against the sp=1 twin: {twin}")


def sp_phase(cd, fa, dev, train=True):
    """The sp part: the kernel pieces, the three bodies at sp 2 and 4, the
    two full-width sp training runs and the tiny fp32 one, each at sp 4
    against its sp=1 twin. Returns the kernels line's sp entries, their
    launches the training runs' totals over the ranks (``sp_train_verdicts``).
    ``train=False``: the pieces and the bodies only, -> the entries; the
    training runs then run in ``mesh_parts``' 4-rank spawn."""
    t0 = time.perf_counter()
    lines = check_sp_kernels(cd, fa, dev)
    log(f"sp kernel pieces done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    for world, t in SP_BODY_RUNS:
        ranks = sp_spawn(world, sp_bodies_rank, {"t": t, "window": 1024, "seed": 22})
        for name in ranks[0]:
            log(f"sp body {name} at sp {world}, T {t}: " + "; ".join(
                f"{n} max abs {max(r[name][n]['max_abs'] for r in ranks):.3e} "
                f"({max(r[name][n]['over_limit'] for r in ranks):.3f} of its limit)"
                for n in ("out", "dq", "dk", "dv"))
                + f"; rank 0 fwd + bwd {ranks[0][name]['ms']['sp']:.1f} ms (first call) against "
                f"{ranks[0][name]['ms']['ref']:.1f} ms single-device")
            if not all(agrees_sp_body(r[name]) for r in ranks):
                raise AssertionError(f"sp body {name} at sp {world}, T {t} disagrees with the "
                                     f"single-device kernel attention: {[r[name] for r in ranks]}")
    log(f"sp bodies done at {time.perf_counter() - t0:.1f} s")
    if not train:
        return lines
    ranks = sp_spawn(4, sp_train_rank, {}, timeout=900)
    log(f"sp training done at {time.perf_counter() - t0:.1f} s")
    return sp_train_verdicts(lines, ranks)


def sp_train_verdicts(lines, ranks):
    """The sp training runs' verdicts (``ranks``: each rank's
    ``sp_train_rank`` results) and the sp entries' launches -> (the
    entries, the readings)."""
    for name in ranks[0]:
        sp_train_verdict(name, [r[name] for r in ranks])
    hybrid, tiny = [r["hybrid_1b3"] for r in ranks], [r["tiny hybrid fp32"] for r in ranks]
    lm = [r["lm_1b3"] for r in ranks]
    for line in lines:
        part = "parts" if "parts" in line["name"] else line["name"].split("_")[1]
        runs = tiny if "_simt" in line["name"] else hybrid
        if part == "parts":
            line["launches"] = sum(c["parts_fwd"] for r in runs for c in r["per_step"])
            line["launches_lm_1b3_sp"] = sum(c["parts_fwd"] for r in lm for c in r["per_step"])
        else:
            line["launches"] = sum(c[f"{part}_sp"] for r in runs for c in r["per_step"])
        line["launches_per_rank"] = [
            sum(c["parts_fwd" if part == "parts" else f"{part}_sp"] for c in r["per_step"])
            for r in runs]
        if not line["launches"]:
            raise AssertionError(f"{line['name']} was not launched in its sp training run")
    return lines, {name: [{k: r[name][k] for k in ("peak_gib", "transport")} for r in ranks]
                   for name in ranks[0]}


# ---------------------------------------------------------------------------
# Data parallelism (A12 steps 2 and 3): the dp and fsdp axes, ranks sharing
# the one card over gloo
# ---------------------------------------------------------------------------

# Each run: (config, overrides, TrainConfig fields, meshes as (dp, fsdp, sp)).
# lm_1b3 at full width, 4 blocks (the first 2 recomputed: the fsdp gathers
# rerun inside the backward), B 8 x 1024 global, the probe and 2 steps, at
# fsdp 4, dp 2 x fsdp 2 and dp 4, each against one dp=1 twin from the same
# seed and batches (rank 0, before the mesh runs); the dropless moe_1b3_4e at
# full width, 4 blocks (block 3 routed, 2048 routed rows a rank: the gmm
# kernels), at dp 2 x fsdp 2, its twin after the mesh run, replaying the mesh
# run's routing gathered over the data ranks (``PinnedRouting`` by batch);
# the probe is each run's first step (its loss and gradients before the
# clip, at the initial params: what ``_train_probe`` computes, with no pass
# of its own);
# the sp part's 4-block hybrid_1b3 (swa, softmax, swa, linear; striped) at dp 2 x
# sp 2, T 2048, B 4; a tiny fp32 hybrid at dp 2 x fsdp 2 (the simt kernels).
# The sp part's readings and limits, unchanged (``dp_train_verdict``); at
# fsdp 4 also each rank's resident params and AdamW state within
# ``DP_RESIDENT_RTOL`` of a quarter of the sharded leaves plus the replicated
# ones, each rank's peak memory below its dp 4 peak, and the save / load
# round trip bitwise.
DP_TRAIN = dict(steps=2, batch_size=8, seq_len=1024, warmup_steps=1)
DP_RUNS = (
    ("lm_1b3", {"n_layers": 4, "remat_skip": 2}, DP_TRAIN, ((1, 4, 1), (2, 2, 1), (4, 1, 1))),
    ("moe_1b3_4e", {"n_layers": 4, "remat_skip": 2, "moe_dropless": True}, DP_TRAIN,
     ((2, 2, 1),)),
    ("hybrid_1b3", dict(SP_TRAIN_RUNS[1][1], sequence_parallel=True),
     dict(SP_TRAIN, batch_size=4), ((2, 1, 2),)),
    ("tiny hybrid fp32", None, dict(SP_TINY, batch_size=4), ((2, 2, 1),)),
)
DP_RESIDENT_RTOL = 0.01


def _dp_model(name, over):
    from orion_tpu_torch.models.configs import TINY, get_config

    if over is None:  # the simt kernels' path
        return dataclasses.replace(TINY, n_layers=4, layer_types=("swa", "softmax", "swa",
                                                                   "linear"), window=16)
    return get_config(name, **over)


def dp_expected_launches(cfg, variant):
    """The launches of one training step on any rank of a data mesh (each
    runs the whole model on its rows): rows 1, 3, 4 once a linear layer (row
    1 twice when recomputed), rows 6-8 once a softmax / swa layer (row 6
    twice when recomputed), rows 9-10 as ``train_phase`` counts them, all of
    ``variant``."""
    lin, attn, lin_remat, attn_remat = _layer_counts(cfg)
    products, products_remat = _gmm_counts(cfg)
    want = dict.fromkeys(KERNELS, 0)
    want.update({f"causal_dot_norm_{variant}": lin + lin_remat,
                 f"causal_dot_dq_den_{variant}": lin, f"causal_dot_rev_den_{variant}": lin,
                 f"flash_fwd_{variant}": attn + attn_remat, f"flash_dq_{variant}": attn,
                 f"flash_dkv_{variant}": attn,
                 f"gmm_fwd_{variant}": 2 * products + products_remat,
                 f"gmm_dw_{variant}": products})
    return want


_CLOCK: dict = {}


def _collective_clock():
    """Host milliseconds in the collectives, by kind: the fsdp gathers, the
    reduce-scatters of the gather's backward, the trainer's all-reduces
    (the gradient sums, the norm's partial sum, the loss), the pipeline's
    receives (a stage waiting for its neighbour's activation or gradient,
    and the hop), and "dist": every call of ``torch.distributed``'s
    gathers, broadcasts, sums and batched exchanges (what ``generate`` on a
    mesh calls; it also holds the calls the other kinds time). Each call is
    timed from a synchronized card to its return (gloo stages through host
    memory, so the call itself waits for the card). Installed once a
    process; later calls hand back the same dict, which its readers zero or
    difference."""
    import torch.distributed as dist

    from orion_tpu_torch.parallel import collectives as co
    from orion_tpu_torch.parallel import pipeline as pipeline_mod
    from orion_tpu_torch.training import trainer as trainer_mod

    if _CLOCK:
        return _CLOCK
    ms = _CLOCK
    ms.update({"gather": 0.0, "reduce_scatter": 0.0, "all_reduce": 0.0, "p2p_recv": 0.0,
               "dist": 0.0})

    def timed(fn, key):
        def call(*a, **kw):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                ms[key] += (time.perf_counter() - t) * 1e3
        return call

    co._gather_cat = timed(co._gather_cat, "gather")
    co._reduce_scatter_raw = timed(co._reduce_scatter_raw, "reduce_scatter")
    trainer_mod.all_reduce_sum_ = timed(co.all_reduce_sum_, "all_reduce")
    pipeline_mod.recv_from = timed(co.recv_from, "p2p_recv")
    for name in ("all_gather", "all_gather_into_tensor", "broadcast", "all_reduce",
                 "batch_isend_irecv"):
        setattr(dist, name, timed(getattr(dist, name), "dist"))
    return ms


def _resident(trainer):
    """(the bytes this rank holds in params and AdamW moments, counted from
    its tensors; the bytes it should hold: 1 / fsdp of each fsdp leaf, 1 /
    tp of each tp leaf (both for a leaf cut by both), each replicated leaf
    whole, only its stage's blocks under pp, from the whole shapes, fp32
    params, mu and nu)."""
    from orion_tpu_torch.convert import expected_params

    held = sum(t.numel() * t.element_size() for t in trainer.params.values())
    held += sum(t.numel() * t.element_size() for key in ("mu", "nu")
                for t in getattr(trainer.opt, key).values())
    cuts = [(a.dims, a.size) for a in trainer.model.shard_axes]
    want = 0
    for key, shape, _ in expected_params(trainer.cfg.model).values():
        if not trainer.model.holds(key):  # another pipeline stage's block
            continue
        numel = int(np.prod(shape))
        for dims, n in cuts:
            numel //= n if key in dims else 1
        want += 3 * 4 * numel  # fp32 param, mu, nu
    return held, want


def _digest(tensors):
    """A bitwise fingerprint of a dict of host tensors (crc32 of each
    leaf's bytes, in name order)."""
    import zlib

    crc = 0
    for n in sorted(tensors):
        crc = zlib.crc32(tensors[n].contiguous().view(torch.uint8).numpy(), crc)
    return crc


def _first_step_grads(trainer, keep):
    """Make ``trainer``'s next step also hand over its loss and gradients
    (summed over the ranks, before the clip: the probe of the sp part,
    without a forward and backward of its own) -> a dict that holds them,
    whole and on the host ("loss", "grads"), once that step has run; the
    gradients only where ``keep`` (under fsdp every rank of each fsdp group
    joins the gather; under pp every rank sends its stage's to stage 0 of
    its pipeline, ``keep`` must be rank 0's alone)."""
    from orion_tpu_torch.parallel.sharding import gather_whole

    box, real = {}, trainer._loss_and_grads

    def capture(batch, seed):
        loss = real(batch, seed)
        trainer._loss_and_grads = real
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in trainer.params.items()}
        if trainer.model.pp is not None:  # every stage's, gathered whole to stage 0
            grads = gather_whole(grads, trainer._gather_axes(), keep=True)
            grads = trainer._merge_stages(grads, to_main=True)
        elif trainer.model.shard_axes:  # fsdp's and tp's shards gathered whole
            grads = gather_whole(grads, trainer._gather_axes(), keep=keep)
        elif keep:
            grads = {n: g.to("cpu", copy=True) for n, g in grads.items()}
        box.update(loss=float(loss), grads=grads if keep else None)
        return loss

    trainer._loss_and_grads = capture
    return box


def _dp_twin(cfg, batches, dev, pin=None):
    """The dp=1 twin of ``cfg`` on this rank's card from the same seed and
    batches (``pin``: replaying a mesh run's routing): its first step's
    loss and gradients, its step losses and grad norms, its params before
    and after, on the host, and its peak memory."""
    from orion_tpu_torch.parallel.mesh import MeshConfig
    from orion_tpu_torch.training.trainer import Trainer

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    twin = Trainer(dataclasses.replace(cfg, mesh=MeshConfig(dp=1)), device=dev)
    p0 = {n: p.detach().to("cpu", torch.float32, copy=True) for n, p in twin.params.items()}
    first = _first_step_grads(twin, keep=True)
    with pin if pin is not None else contextlib.nullcontext():
        if pin is not None:
            pin.attach(twin.model)
        steps = []
        for i, b in enumerate(batches):
            if pin is not None:
                pin.epoch = i + 1
            ms, m = _timed(lambda: twin.step(b), dev)
            steps.append({"ms": ms, "loss": m["loss"], "grad_norm": m["grad_norm"]})
    after = {n: p.detach().to("cpu", torch.float32, copy=True) for n, p in twin.params.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    del twin
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"probe_loss": first["loss"], "grads": first["grads"], "steps": steps, "p0": p0,
            "after": after, "flips": pin.flips if pin is not None else 0, "peak_gib": peak}


def _against_twin(twin, probe_loss, grads, after, tiny, dev):
    """The sp part's readings of a mesh run (its first step's loss and whole
    gradients, its whole params after the steps) against its twin, each leaf
    compared on ``dev``."""
    rel, agree, total = {}, 0, 0
    for n, g in grads.items():
        ref = twin["grads"][n].to(dev)
        rel[n] = float((g.to(dev).float() - ref).norm() / ref.norm().clamp_min(1e-30))
        p0 = twin["p0"][n].to(dev)
        du_mesh, du = after[n].to(dev).float() - p0, twin["after"][n].to(dev) - p0
        agree += int((torch.sign(du_mesh) == torch.sign(du)).sum())
        total += du.numel()
    worst = max(rel.items(), key=lambda kv: kv[1])
    return {"probe_loss": probe_loss, "twin_probe_loss": twin["probe_loss"],
            "grad_rel_l2_max": worst[1], "grad_worst": worst[0],
            "twin_losses": [s["loss"] for s in twin["steps"]],
            "twin_grad_norms": [s["grad_norm"] for s in twin["steps"]],
            "twin_ms": [s["ms"] for s in twin["steps"]],
            "update_sign_agree": agree / total, "tiny": tiny, "flips": twin["flips"],
            "twin_peak_gib": twin["peak_gib"]}


def _remesh(mesh, cfg, device):
    from orion_tpu_torch.parallel.mesh import init_distributed

    if cfg == mesh.cfg:
        return mesh
    return init_distributed(cfg, rank=mesh.rank, world_size=mesh.world, local_rank=mesh.rank,
                            local_world_size=mesh.world, device=device)


def _dp_mesh_run(m, cfg, batches, mods, clock, pin, save_dir, tiny):
    """One mesh run on this rank: the Trainer at ``m``, the steps with their
    launches and collective ms (the first step's loss and whole gradients
    taken for the probe), the whole params and their digest, the peak
    memory; with ``save_dir`` (fsdp 4 on lm_1b3) the save / load round
    trip. Rank 0's result keeps the probe and the whole params ("whole")
    for the twin."""
    from orion_tpu_torch.ops.kernels import causal_dot as cd, flash_attention as fa
    from orion_tpu_torch.training.checkpoint import Checkpointer, load_params
    from orion_tpu_torch.training.trainer import Trainer

    dev = m.device
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(dataclasses.replace(cfg, mesh=m.cfg), mesh=m)
    held, want_held = _resident(trainer)
    res = {"mesh": m.cfg.shape, "transport": m.transport, "held": held, "want_held": want_held,
           "n_micro": trainer.pp_n_micro, "full_manual": trainer.pp_full_manual}
    if isinstance(pin, PipelinePinnedRouting):
        pin.n_micro, pin.full_manual = trainer.pp_n_micro, trainer.pp_full_manual
    first = _first_step_grads(trainer, keep=m.is_main)
    with pin if pin is not None else contextlib.nullcontext():
        if pin is not None:
            pin.attach(trainer.model)
        steps, per_step, per_step_sp = [], [], []
        for i, b in enumerate(batches):
            if pin is not None:
                pin.epoch = i + 1
            _reset_counts(mods)
            _sp_reset(cd, fa)  # the sp counters too (shift / q_offset launches)
            for k in clock:
                clock[k] = 0.0
            ms, met = _timed(lambda: trainer.step(b), dev)
            per_step.append(_counts(mods))
            per_step_sp.append(_sp_counts(cd, fa))
            steps.append({"ms": ms, "loss": met["loss"], "grad_norm": met["grad_norm"],
                          "collective_ms": dict(clock)})
    whole = trainer.whole_params()
    res.update(steps=steps, per_step=per_step, per_step_sp=per_step_sp, digest=_digest(whole),
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                         else 0.0),
               # the leaves every stage holds, this rank's own (bitwise on every rank)
               trunk_digest=_digest({n: whole[n] for n in whole if not n.startswith("blocks.")}))
    if save_dir is not None and trainer.model.pp is not None:
        res.update(pp_checkpoint(m, trainer, cfg, save_dir, whole, dev))
    elif save_dir is not None:
        ck = Checkpointer(save_dir, save_every=0)
        t0 = time.perf_counter()
        trainer._save(ck, trainer.step_count, force=True)
        res["save_s"] = time.perf_counter() - t0
        mine = {n: p.detach().clone() for n, p in trainer.params.items()}
        if m.rank == 1:  # one rank's load of the file: its own shards back, bitwise
            trainer.restore(ck, trainer.step_count)
            res["reload_bitwise"] = all(torch.equal(trainer.params[n], mine[n]) for n in mine)
        if m.is_main:  # the serving side's load (a dp=1 model's params): the whole params
            params, _ = load_params(save_dir)
            res["dp1_load_bitwise"] = all(torch.equal(params[n], whole[n]) for n in whole)
        m.barrier()
    if m.is_main:
        res["whole"] = (first["loss"], first["grads"], whole)
    del trainer, first
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _gather_routes(pin, m, t_loc=None):
    """The mesh run's pinned choices, each rank's rows gathered over the
    data group in data-rank order (the global batch's row order), a
    sequence-parallel rank's tokens first over the sp group in sp-rank order
    (each row's ``t_loc`` tokens a rank: the global token order); under pp
    each (layer, epoch)'s microbatches joined in order (partial-manual:
    microbatch m is every data rank's share of the global microbatch m, so
    microbatch-major, then data-rank order, is the global row order), and
    every stage's layers gathered to every rank of the pipeline."""
    import torch.distributed as dist

    from orion_tpu_torch.parallel.collectives import _gather_cat

    def rows(ids):
        if m.sp > 1:  # [B T_loc, k] -> [B T, k]: each row's shards in token order
            k = ids.shape[-1]
            ids = _gather_cat(ids.reshape(-1, t_loc, k), 1, m.sp_group).reshape(-1, k)
        return ids if m.data_group is None else _gather_cat(ids, 0, m.data_group)

    if m.pp == 1:
        return {key: rows(ids) for key, ids in sorted(pin.routes.items())}
    if m.n_data > 1 and pin.full_manual:
        raise ValueError("the pinned routes of a full-manual pipeline are not in the global "
                         "row order; run the MoE partial-manual")
    mine = {}
    for layer, epoch in sorted({k[:2] for k in pin.routes}):
        mine[(layer, epoch)] = torch.cat([rows(pin.routes[(layer, epoch, i)])
                                          for i in range(pin.n_micro)]).cpu()
    stages = [None] * m.pp
    dist.all_gather_object(stages, mine, group=m.pp_group)
    return {k: v.to(m.device) for st in stages for k, v in st.items()}


def _mesh_label(name, shape):
    """A mesh run's label: (dp, fsdp, sp) shapes as the dp part names them,
    (dp, fsdp, tp, sp) ones with their tp, (dp, fsdp, tp, sp, pp) ones with
    their pp."""
    if len(shape) == 3:
        return f"{name} at dp {shape[0]} x fsdp {shape[1]} x sp {shape[2]}"
    label = f"{name} at dp {shape[0]} x fsdp {shape[1]} x tp {shape[2]} x sp {shape[3]}"
    return label + (f" x pp {shape[4]}" if len(shape) == 5 else "")


def _shape_mesh(shape):
    """The ``MeshConfig`` of a run's mesh tuple: (dp, fsdp, sp), (dp, fsdp,
    tp, sp) or (dp, fsdp, tp, sp, pp)."""
    from orion_tpu_torch.parallel.mesh import MeshConfig

    if len(shape) == 3:
        return MeshConfig(dp=shape[0], fsdp=shape[1], sp=shape[2])
    return MeshConfig(dp=shape[0], fsdp=shape[1], tp=shape[2], sp=shape[3],
                      pp=shape[4] if len(shape) == 5 else 1)


def _stage_model(cfg, m):
    """The config of the blocks this rank's pipeline stage holds, every one
    recomputed (the pipeline's ``remat_skip`` 0): its launch counts are
    ``dp_expected_launches`` / ``sp_expected_launches`` of it. A stage starts
    at a group boundary, so its layer and MoE pattern is the model's from 0."""
    from orion_tpu_torch.parallel.pipeline_lm import stage_blocks

    held = stage_blocks(cfg, m.pp, m.pp_rank)
    return dataclasses.replace(cfg, n_layers=len(held), remat_skip=0,
                               layer_types=tuple(cfg.resolved_layer_types[i] for i in held))


def dp_train_rank(mesh, payload):
    """One rank of the dp part: for each run of ``payload["runs"]``
    (default ``DP_RUNS``) every mesh of it on this process group, with rank
    0's twin before (or, for a MoE, after) them -> per run and mesh: the
    rank's readings; rank 0's against the twin. A mesh is (dp, fsdp, sp) or
    (dp, fsdp, tp, sp) (the tp part's runs). A run's optional fifth item
    (the combos part's) asks for more: ``"audit"``, the rows whose every
    launch in the mesh run is held against its plain version
    (``LaunchAudit``); ``"masks"``, every dropout mask of the mesh run held
    bitwise against the twin's (``MaskTap``, ``res["masks"]``)."""
    from orion_tpu_torch.ops.kernels import adafactor, causal_dot, flash_attention, gmm, q4_matmul
    from orion_tpu_torch.parallel.mesh import MeshConfig
    from orion_tpu_torch.training.data import SyntheticDataset, device_batch
    from orion_tpu_torch.training.trainer import TrainConfig

    mods = (causal_dot, flash_attention, gmm, q4_matmul, adafactor)
    dev = mesh.device
    clock = _collective_clock()
    results = {}
    for name, over, kw, meshes, *extra in payload.get("runs", DP_RUNS):
        opts = extra[0] if extra else {}
        model = _dp_model(name, over)
        cfg = TrainConfig(model=model, **kw)
        ds = SyntheticDataset(model.vocab_size, cfg.seq_len)
        batches = [device_batch(ds, cfg.seed, i, cfg.batch_size, dev) for i in range(cfg.steps)]
        routed = bool(model.n_experts)
        twin_masks = MaskTap(keep_full=True) if opts.get("masks") else None
        twin = None
        if mesh.is_main and not routed:
            with twin_masks if twin_masks is not None else contextlib.nullcontext():
                twin = _dp_twin(cfg, batches, dev)
        mesh.barrier()
        for shape in meshes:
            m = _remesh(mesh, _shape_mesh(shape), payload.get("device"))
            pin = (PipelinePinnedRouting() if m.pp > 1 else PinnedRouting()) if routed else None
            save = (payload.get("save_dir") if name == "lm_1b3"
                    and shape in payload.get("save_shapes", ((1, 4, 1),)) else None)
            audit = LaunchAudit(mods, opts["audit"]) if opts.get("audit") else None
            tap = MaskTap() if opts.get("masks") else None
            with contextlib.ExitStack() as stack:
                for ctx in (audit, tap):
                    if ctx is not None:
                        stack.enter_context(ctx)
                res = _dp_mesh_run(m, cfg, batches, mods, clock, pin, save, over is None)
            if audit is not None:
                res["audit"] = audit.reading()
            if tap is not None:  # every rank's draws, held against the twin's on rank 0
                res["masks"] = twin_masks.check(tap.gather(), m) if mesh.is_main else None
                if not mesh.is_main:
                    tap.gather()
            # under pp a rank's step is its stage's blocks, every one recomputed,
            # once a microbatch
            stage = _stage_model(model, m) if m.pp > 1 else model
            times = res["n_micro"] if m.pp > 1 else 1
            variant = "simt" if over is None else "wgmma"
            want_sp = ({k: times * v for k, v in sp_expected_launches(
                stage, m.sp_rank, m.sp, cfg.seq_len // m.sp).items()} if m.sp > 1 else None)
            res.update(want={k: times * v for k, v in dp_expected_launches(stage, variant).items()}
                       if m.sp == 1 else None, want_sp=want_sp, tiny=over is None)
            if m.sp > 1 and routed:  # rows 9-10 on a rank's token shard, as at sp 1
                res["want_gmm"] = {k: times * v for k, v in dp_expected_launches(
                    stage, variant).items() if k.startswith("gmm")}
            routes = _gather_routes(pin, m, cfg.seq_len // m.sp) if routed else None
            mesh.barrier()
            if mesh.is_main:
                loss, grads, whole = res.pop("whole")
                if routed:  # the twin replays the mesh run's routing
                    replay = PinnedRouting()
                    replay.routes = {k: v.to(dev) for k, v in routes.items()}
                    twin = _dp_twin(cfg, batches, dev, replay)
                res["twin"] = _against_twin(twin, loss, grads, whole, over is None, dev)
                del grads, whole
            mesh.barrier()
            results[_mesh_label(name, shape)] = res
        del twin
    return results


def dp_train_verdict(label, ranks):
    """Log a mesh run's readings; raise where a limit is missed, a launch
    count is off, the ranks disagree, or (fsdp 4) the resident bytes or the
    round trip miss."""
    twin = ranks[0]["twin"]
    tiny = twin["tiny"]
    loss_atol = TINY_LOSS_ATOL if tiny else LM_LOSS_ATOL
    grad_lim = SP_TINY_GRAD_REL_L2 if tiny else LM_GRAD_REL_L2
    losses = [s["loss"] for s in ranks[0]["steps"]]
    norms = [s["grad_norm"] for s in ranks[0]["steps"]]
    coll = [{k: round(v, 1) for k, v in s["collective_ms"].items()} for s in ranks[0]["steps"]]
    log(f"dp train {label} (transport {ranks[0]['transport']}): probe loss "
        f"{twin['probe_loss']:.6f} vs the dp=1 twin's {twin['twin_probe_loss']:.6f}; gradients' "
        f"largest relative L2 error {twin['grad_rel_l2_max']:.3e} ({twin['grad_worst']}; limit "
        f"{grad_lim:g}); step losses {losses} vs {twin['twin_losses']} (limit {loss_atol:g}); "
        f"grad norms {norms} vs {twin['twin_grad_norms']}; update signs agree on "
        f"{twin['update_sign_agree']:.4f} of the elements (limit {SP_UPDATE_AGREE}); routing "
        f"flips the twin replayed {twin['flips']}; step ms a rank "
        f"{[[round(s['ms'], 1) for s in r['steps']] for r in ranks]} (the twin's "
        f"{[round(x, 1) for x in twin['twin_ms']]}); rank 0's host ms in the collectives a "
        f"step {coll}; resident params + AdamW state a rank {[r['held'] for r in ranks]} bytes "
        f"(want {ranks[0]['want_held']}); peak memory a rank "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB")
    for r, res in enumerate(ranks):
        if res["want"] is not None and any(c[k] != v for c in res["per_step"]
                                           for k, v in res["want"].items()):
            raise AssertionError(f"dp {label} rank {r}: launches {res['per_step']}, want "
                                 f"{res['want']} a step")
        if res["want_sp"] is not None and any(c[k] != v for c in res["per_step_sp"]
                                              for k, v in res["want_sp"].items()):
            raise AssertionError(f"dp {label} rank {r}: sp launches {res['per_step_sp']}, want "
                                 f"{res['want_sp']} a step")
        kinds = {"wgmma": sum(c["wgmma"] for c in res["per_step_sp"]),
                 "simt": sum(c["simt"] for c in res["per_step_sp"])}
        if kinds["simt" if not tiny else "wgmma"] or not kinds["wgmma" if not tiny else "simt"]:
            raise AssertionError(f"dp {label} rank {r} took the other variant: {kinds}")
        if abs(res["held"] - res["want_held"]) > DP_RESIDENT_RTOL * res["want_held"]:
            raise AssertionError(f"dp {label} rank {r} holds {res['held']} bytes of params and "
                                 f"moments, want {res['want_held']}")
    if len({tuple(s["loss"] for s in res["steps"]) for res in ranks}) != 1 or \
            len({res["digest"] for res in ranks}) != 1:
        raise AssertionError(f"dp {label}: the ranks end with other losses or params: "
                             f"{[(res['steps'], res['digest']) for res in ranks]}")
    if "save_s" in ranks[0]:
        log(f"dp {label}: saved in {ranks[0]['save_s']:.1f} s; rank 1's load of the file "
            f"bitwise its shards {ranks[1]['reload_bitwise']}; a dp=1 load bitwise the gathered "
            f"params {ranks[0]['dp1_load_bitwise']}")
        if not (ranks[1]["reload_bitwise"] and ranks[0]["dp1_load_bitwise"]):
            raise AssertionError(f"dp {label}: the checkpoint round trip is not bitwise")
    missed = (abs(twin["probe_loss"] - twin["twin_probe_loss"]) > loss_atol
              or twin["grad_rel_l2_max"] > grad_lim
              or any(abs(a - b) > loss_atol for a, b in zip(losses, twin["twin_losses"]))
              or any(abs(a - b) > grad_lim * b for a, b in zip(norms, twin["twin_grad_norms"]))
              or twin["update_sign_agree"] < SP_UPDATE_AGREE
              or not all(np.isfinite(x) for x in losses))
    if missed:
        raise AssertionError(f"dp training {label} misses its limits against the dp=1 twin: "
                             f"{twin}")


def _mesh_launches(ranks, launches=None):
    """Each kernel's launches over the mesh runs' steps and ranks (``ranks``:
    each rank's ``dp_train_rank`` results), by ``KERNELS`` name and by the
    sp entries' names (the parts and the sp flash calls of a run with sp),
    added to ``launches``."""
    launches = launches if launches is not None else dict.fromkeys(KERNELS, 0)
    sp_names = {"parts_fwd": "causal_dot_parts", "fwd_sp": "flash_fwd",
                "dq_sp": "flash_dq", "dkv_sp": "flash_dkv"}
    for r in ranks:
        for res in r.values():
            for c in res["per_step"]:
                for k in KERNELS:
                    launches[k] += c[k]
            if res["want_sp"] is not None:  # the sp entries' launches: a run with sp
                variant = "simt" if res["tiny"] else "wgmma"
                for c in res["per_step_sp"]:
                    for key, base in sp_names.items():
                        name = (f"{base}_{variant}" if base == "causal_dot_parts"
                                else f"{base}_{variant}_sp")
                        launches[name] = launches.get(name, 0) + c[key]
    return launches


def dp_verdicts(four):
    """The dp part's verdicts on the 4-rank spawn's results (``four``: each
    rank's ``dp_train_rank`` results): each mesh run against its dp=1 twin
    (``dp_train_verdict``), fsdp 4's peak below dp 4's on every rank.
    Returns (each kernel's launches over the dp runs' steps and ranks, by
    ``KERNELS`` name and by the sp entries' names; the readings)."""
    labels = [_mesh_label(name, shape) for name, _, _, meshes in DP_RUNS for shape in meshes]
    ranks = [{label: r[label] for label in labels} for r in four]
    for label in labels:
        dp_train_verdict(label, [r[label] for r in ranks])
    lm = {shape: [r[f"lm_1b3 at dp {shape[0]} x fsdp {shape[1]} x sp 1"] for r in ranks]
          for shape in ((1, 4), (4, 1))}
    peaks = [(a["peak_gib"], b["peak_gib"]) for a, b in zip(lm[(1, 4)], lm[(4, 1)])]
    log(f"dp lm_1b3 peak memory a rank, fsdp 4 against dp 4: {peaks} GiB")
    if not all(a < b for a, b in peaks):
        raise AssertionError(f"fsdp 4's peak memory is not below dp 4's on every rank: {peaks}")
    launches = _mesh_launches(ranks)
    log(f"dp part: launches over its runs: {launches}")
    return launches, {label: [{k: r[label][k] for k in ("peak_gib", "held", "transport")}
                              for r in ranks] for label in labels}


def dp_phase(dev):
    """The dp part alone (``mesh_parts``)."""
    return mesh_parts(dev, ("dp",))["dp"]


# ---------------------------------------------------------------------------
# Tensor parallelism (A12 step 4): the heads and the MLPs' hidden dimension
# over tp, ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

# Each run: (config, overrides, TrainConfig fields, meshes as (dp, fsdp, tp,
# sp)), read by ``dp_train_rank`` against a tp=1 twin from the same seed and
# batches with the dp part's readings and limits (``dp_train_verdict``: the
# probe's loss and every gradient, the step losses and grad norms, the
# update signs, exact launches a rank, the ranks' params bitwise, each
# rank's resident params and moments within ``DP_RESIDENT_RTOL`` of 1 / tp
# of each tp leaf plus the rest whole). (a), on 2 ranks: lm_1b3 at full
# width, 4 blocks (2 recomputed; full depth until the pp part took its time,
# which runs lm_1b3 at full depth on a mesh), B 8 x 1024, two AdamW steps at
# tp 2; each rank's peak memory also below the twin's. (b), on 4 ranks at 4
# blocks (2 recomputed): the hybrid (swa, softmax, swa, linear) at dp 2 x tp
# 2, B 8 x 1024 (rows 6-8 and 1, 3, 4 at 8 of its 16 heads); lm_1b3 at sp 2 x
# tp 2, T 2048, B 2 (the sp parts at 8 heads); the dropless moe_1b3_4e at
# fsdp 2 x tp 2, B 8 x 1024 (rows 9-10 on 2752 of the 5504 hidden columns),
# its twin replaying the mesh run's routing.
TP_DEPTH = {"n_layers": 4, "remat_skip": 2}  # (a)'s and (c)'s cut
TP_HYBRID_DEPTH = {"n_layers": 4, "remat_skip": 2,  # both layer kinds kept
                   "layer_types": ("swa", "swa", "swa", "linear")}
TP_TRAIN_2 = (("lm_1b3", TP_DEPTH, DP_TRAIN, ((1, 1, 2, 1),)),)
TP_TRAIN_4 = (
    ("hybrid_1b3", {"n_layers": 4, "remat_skip": 2,
                    "layer_types": ("swa", "softmax", "swa", "linear")}, DP_TRAIN,
     ((2, 1, 2, 1),)),
    ("lm_1b3", {"n_layers": 4, "remat_skip": 2, "sequence_parallel": True}, SP_TRAIN,
     ((1, 1, 2, 2),)),
    ("moe_1b3_4e", {"n_layers": 4, "remat_skip": 2, "moe_dropless": True}, DP_TRAIN,
     ((1, 2, 2, 1),)),
)
# (c), on the 2 ranks of (a): generate at tp 2, lm_1b3 at 4 blocks (4
# prompts of 1024) and hybrid_1b3 at 4 (4 of 1536, past its window), 32 greedy
# tokens. The tp=1 run's tokens teacher-forced through the tp model: each
# step's logits within ``TP_LOGITS_ATOL`` of the tp=1 run's, this rank's
# heads of every layer's state after the prefill and after the last step
# within ``TP_S_RTOL`` / ``TP_KV_RTOL`` of the same heads of the tp=1 state
# (relative to its largest element); the logits bitwise the same on both
# ranks; the free-running greedy tokens that match tp=1's counted (a
# reading). The limits: tp rounds each rank's wo and down partial outputs
# to bf16 before their fp32 sum (the reference's GSPMD form sums them in
# bf16), one more bf16 rounding a block than the tp=1 product. Unlike the
# kernel paths' roundings (``LOGITS_ATOL``, ``LAYER_*_RTOL``), these sit on
# the residual stream itself, and a layer's S error grows with the blocks
# below it: in a CPU rehearsal of this check at lm_1b3's width, the deepest
# layer's S error roughly doubled from 6 to 12 blocks, and the logits' error
# grew by a third. The limits are twice that growth carried to 24 blocks: S
# 2e-2, K/V 3e-2 (one bf16 projection of the layer's input, as for
# ``LAYER_KV_RTOL``), logits 0.25. A wrong head, shard or sum moves them by
# the values' own size (about 1).
TP_GENERATE = (("lm_1b3", TP_DEPTH, 1024, 32), ("hybrid_1b3", TP_HYBRID_DEPTH, 1536, 32))
TP_LOGITS_ATOL, TP_S_RTOL, TP_KV_RTOL = 0.25, 2e-2, 3e-2
# the kernels the tp part must launch (every one of its path)
TP_PATH = ("causal_dot_norm_wgmma", "causal_dot_dq_den_wgmma", "causal_dot_rev_den_wgmma",
           "flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma", "gmm_fwd_wgmma",
           "gmm_dw_wgmma", "causal_dot_parts_wgmma")


def _logits_digest(chunks):
    """crc32 of the bytes of a list of tensors, in order."""
    import zlib

    crc = 0
    for t in chunks:
        crc = zlib.crc32(t.detach().contiguous().cpu().view(torch.uint8).numpy(), crc)
    return crc


def tp_generate_rank(mesh, payload):
    """One rank of (c): for each run of ``payload.get("generate",
    TP_GENERATE)``, the tp=1 twin on this rank's card (prefill and 31
    decode steps on its own greedy tokens, its logits and this rank's heads
    of its states kept), then the model at tp on this mesh: the prefill and
    the twin's tokens teacher-forced, then ``generate`` free-running, with
    every launch counted -> per run: the readings."""
    from orion_tpu_torch.generate import SampleConfig, cast_params_for_inference, generate
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.ops.kernels import adafactor, causal_dot, flash_attention, gmm, q4_matmul

    mods = (causal_dot, flash_attention, gmm, q4_matmul, adafactor)
    dev, t = mesh.device, mesh.tp_rank
    out = {}
    for name, over, prompt_len, new in payload.get("generate", TP_GENERATE):
        cfg = get_config(name, **over)
        heads = cfg.n_heads // mesh.tp

        def mine(states):
            return [{k: v[:, t * heads:(t + 1) * heads].clone() for k, v in st.items()}
                    for st in states]

        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (4, prompt_len), dtype=np.int64)).to(dev)
        gc.collect()
        twin = cast_params_for_inference(TransformerLM(cfg, device=dev))
        with torch.inference_mode():
            logits, states = twin.prefill_last(prompts)
            ref_logits, tokens, ref_first = [logits], [logits.argmax(-1)], mine(states)
            for i in range(new - 1):
                logits, states = twin.decode_step(tokens[-1], states, prompt_len + i)
                ref_logits.append(logits)
                tokens.append(logits.argmax(-1))
            ref_last = mine(states)
        del twin, states, logits
        torch.cuda.empty_cache()
        model = cast_params_for_inference(TransformerLM(cfg, device=dev, mesh=mesh))
        mesh.barrier()
        with torch.inference_mode():
            _reset_counts(mods)
            t0 = time.perf_counter()
            logits, states = model.prefill_last(prompts)
            got, first_err = [logits], _state_err(states, ref_first)
            for i in range(new - 1):
                logits, states = model.decode_step(tokens[i], states, prompt_len + i)
                got.append(logits)
            torch.cuda.synchronize()
            forced_ms = (time.perf_counter() - t0) * 1e3
            last_err = _state_err(states, ref_last)
            del states
            free_ms, free = wall_ms(lambda: generate(model, prompts, new,
                                                     SampleConfig(temperature=0.0)))
            counts = _counts(mods)
        want = torch.stack(tokens, 1)
        same = (free == want).cpu()
        first_miss = [int(row.logical_not().nonzero()[0]) if not row.all() else new
                      for row in same]
        lin, attn, _, _ = _layer_counts(cfg)
        out[f"{name} generate at tp {mesh.tp}"] = {
            "logits_err": [float((a - b).abs().max()) for a, b in zip(got, ref_logits)],
            "finite": all(bool(torch.isfinite(a).all()) for a in got),
            "s_err": (first_err[0], last_err[0]), "kv_err": (first_err[1], last_err[1]),
            "digest": _logits_digest(got), "tokens_digest": _logits_digest([free]),
            "free_match": int(same.sum()), "free_prefix": first_miss, "new": new,
            "counts": counts,
            # the prefill of the forced run and of the free-running generate
            "want": {**dict.fromkeys(KERNELS, 0), "causal_dot_norm_wgmma": 2 * lin,
                     "flash_fwd_wgmma": 2 * attn},
            "forced_ms": forced_ms, "free_ms": free_ms, "transport": mesh.transport}
        del model, got, ref_logits, ref_first, ref_last
        torch.cuda.empty_cache()
        mesh.barrier()
    return out


def tp_generate_verdict(label, ranks):
    """Log (c)'s readings; raise where a limit is missed, a launch count is
    off or the ranks disagree."""
    r0 = ranks[0]
    log(f"tp {label} (transport {r0['transport']}): teacher-forced logits against tp=1, max "
        f"abs a step up to {max(max(r['logits_err']) for r in ranks):.4e} (limit "
        f"{TP_LOGITS_ATOL}; rank 0's by step {[round(x, 4) for x in r0['logits_err']]}); this "
        f"rank's heads of the states, max rel after the prefill / the last step: S "
        f"{[r['s_err'] for r in ranks]} (limit {TP_S_RTOL:g}), K/V "
        f"{[r['kv_err'] for r in ranks]} (limit {TP_KV_RTOL:g}); free-running greedy "
        f"tokens equal to tp=1's {r0['free_match']} of {4 * r0['new']} (first miss a row "
        f"{r0['free_prefix']}); prefill + {r0['new'] - 1} forced steps {r0['forced_ms']:.1f} "
        f"ms, generate {r0['free_ms']:.1f} ms a rank; launches a rank "
        f"{[{k: v for k, v in r['counts'].items() if v} for r in ranks]}")
    for i, r in enumerate(ranks):
        if r["counts"] != r["want"]:
            raise AssertionError(f"tp {label} rank {i}: launches {r['counts']}, want {r['want']}")
        missed = (not r["finite"] or max(r["logits_err"]) > TP_LOGITS_ATOL
                  or max(e or 0.0 for e in r["s_err"]) > TP_S_RTOL
                  or max(e or 0.0 for e in r["kv_err"]) > TP_KV_RTOL)
        if missed:
            raise AssertionError(f"tp {label} rank {i} misses its limits against tp=1: {r}")
    if len({r["digest"] for r in ranks}) != 1 or len({r["tokens_digest"] for r in ranks}) != 1:
        raise AssertionError(f"tp {label}: the ranks' logits or tokens differ")


def tp_verdicts(two, four):
    """The tp part's verdicts on the spawns' results (``two``: the 2-rank
    spawn's, each rank's {"tp_train": ..., "generate": ...}; ``four``: the
    4-rank spawn's ``dp_train_rank`` results): (a) and (b) against their
    tp=1 twins, (a)'s peak memory below the twin's, (c) against tp=1.
    Returns (each kernel's launches over the part's runs and ranks, by
    ``KERNELS`` name and by the sp entries' names; the readings)."""
    train2 = [r["tp_train"] for r in two]
    labels4 = [_mesh_label(name, shape) for name, _, _, meshes in TP_TRAIN_4 for shape in meshes]
    four = [{label: r[label] for label in labels4} for r in four]
    for label in train2[0]:
        ranks = [r[label] for r in train2]
        dp_train_verdict(label, ranks)
        twin_peak = ranks[0]["twin"]["twin_peak_gib"]
        peaks = [r["peak_gib"] for r in ranks]
        log(f"tp {label}: peak memory a rank {[round(p, 2) for p in peaks]} GiB against the "
            f"tp=1 twin's {twin_peak:.2f} GiB")
        if not all(p < twin_peak for p in peaks):
            raise AssertionError(f"tp {label}: a rank's peak memory {peaks} GiB is not below the "
                                 f"tp=1 twin's {twin_peak:.2f} GiB")
    for label in labels4:
        dp_train_verdict(label, [r[label] for r in four])
    for label in two[0]["generate"]:
        tp_generate_verdict(label, [r["generate"][label] for r in two])
    launches = _mesh_launches(train2 + four)
    for r in two:
        for res in r["generate"].values():
            for k in KERNELS:
                launches[k] += res["counts"][k]
    missing = [k for k in TP_PATH if not launches.get(k)]
    log(f"tp part: launches over its runs: {launches}")
    if missing:
        raise AssertionError(f"the tp part launched no {missing}")
    readings = {label: [{k: r[label][k] for k in ("peak_gib", "held", "transport")}
                        for r in rs] for rs in (train2, four) for label in rs[0]}
    return launches, readings


def tp_phase(dev):
    """The tp part alone (``mesh_parts``)."""
    return mesh_parts(dev, ("tp",))["tp"]


# ---------------------------------------------------------------------------
# Pipeline parallelism (A12 step 5): GPipe stages over depth, ranks sharing
# the one card over gloo
# ---------------------------------------------------------------------------

# Each run: (config, overrides, TrainConfig fields, meshes as (dp, fsdp, tp,
# sp, pp)), read by ``dp_train_rank`` against a pp=1 twin from the same seed
# and batches with the dp part's readings and limits (``dp_train_verdict``:
# the probe's loss and every gradient, the step losses and grad norms, the
# update signs, exact launches a rank -- a stage's blocks, every one
# recomputed, once a microbatch --, the ranks' params bitwise, each rank's
# resident params and moments within ``DP_RESIDENT_RTOL`` of its stage's
# blocks plus the leaves every stage holds). (a), on 2 ranks: lm_1b3 at full
# width, 4 blocks (2 a stage; full depth, 12 a stage, until the combos part
# took its time), B 8 x 1024, two AdamW steps at pp 2 with the auto n_micro
# (8); each rank's peak memory also below the twin's,
# the leaves every stage holds bitwise on both ranks, each rank's host ms
# waiting on its neighbour beside the bubble (pp - 1) / (n_micro + pp - 1).
# (c) on (a)'s ranks: the step-2 checkpoint (the pp=1 file: each stage's
# blocks sent to rank 0), a pp=1 Trainer's load of its params bitwise the
# gathered ones, and ``orion_tpu_torch.evaluate``'s ``lm_eval_sums`` of
# that model on ``PP_EVAL_BATCHES`` batches against the pp Trainer's own
# ``evaluate`` of them within ``PP_EVAL_ATOL``. (b), on 4 ranks at reduced
# depth (2 recomputed in the twin): the hybrid (swa, swa, swa, linear) x 2 at
# pp 2 x dp 2 (one group a stage; full-manual, the card's rule), B 8 x 1024;
# the dropless moe_1b3_4e at 8 blocks (two groups of 3 dense + 1 MoE) at pp
# 2 x fsdp 2 (partial-manual), B 8 x 1024, at one microbatch (the load-balance
# term of a microbatch is not that of the batch: only at n_micro 1 is the
# step a pp=1 step, as in the JAX package; n_micro 2 in both forms is held
# against the JAX Trainer on the CPU, ``tests/test_torch_pp_moe.py``), its
# twin replaying the pipeline's routing (``PipelinePinnedRouting``); lm_1b3
# at 4 blocks at pp 2 x sp 2, T
# 2048, B 2 (the sp parts inside the stages). pp x tp runs on the CPU only
# (``tests/test_torch_pp_trainer.py``).
PP_TRAIN_2 = (("lm_1b3", {"n_layers": 4}, DP_TRAIN, ((1, 1, 1, 1, 2),)),)
PP_TRAIN_4 = (
    ("hybrid_1b3", {"n_layers": 8, "remat_skip": 2,
                    "layer_types": ("swa", "swa", "swa", "linear") * 2}, DP_TRAIN,
     ((2, 1, 1, 1, 2),)),
    ("moe_1b3_4e", {"n_layers": 8, "remat_skip": 2, "moe_dropless": True},
     dict(DP_TRAIN, pp_microbatches=1), ((1, 2, 1, 1, 2),)),
    ("lm_1b3", {"n_layers": 4, "remat_skip": 2, "sequence_parallel": True}, SP_TRAIN,
     ((1, 1, 1, 2, 2),)),
)
PP_EVAL_BATCHES = 2
# (c)'s limit: the pp Trainer evaluates each microbatch of one row through
# its stages, the pp=1 model the whole batch: the same bf16 products at
# other row counts, so each token's loss moves by bf16 noise (~1e-3 of
# ~10.8) and the mean over 16384 tokens far less; a wrong stage or block
# moves it by the loss's own scale
PP_EVAL_ATOL = 5e-3
# the kernels the pp part must launch (every one of its path)
PP_PATH = TP_PATH


def pp_checkpoint(m, trainer, cfg, save_dir, whole, dev):
    """(c) on every rank of (a)'s pipeline: the step's checkpoint saved (a
    collective: each stage's leaves sent to rank 0, which writes the pp=1
    file), the pp Trainer's ``evaluate`` of ``PP_EVAL_BATCHES`` batches;
    then on rank 0 a pp=1 Trainer loads the file's params (against the
    gathered ``whole``, bitwise) and ``orion_tpu_torch.evaluate``'s
    ``lm_eval_sums`` evaluates the same batches on its model."""
    from orion_tpu_torch.evaluate import lm_eval_sums
    from orion_tpu_torch.parallel.mesh import MeshConfig
    from orion_tpu_torch.training.checkpoint import Checkpointer, load_params
    from orion_tpu_torch.training.data import SyntheticDataset, device_batch
    from orion_tpu_torch.training.trainer import Trainer

    out = {}
    t0 = time.perf_counter()
    trainer._save(Checkpointer(save_dir, save_every=0), trainer.step_count, force=True)
    out["pp_save_s"] = time.perf_counter() - t0
    ds = SyntheticDataset(cfg.model.vocab_size, cfg.seq_len)
    batches = [device_batch(ds, cfg.seed + 1, i, cfg.batch_size, dev)
               for i in range(PP_EVAL_BATCHES)]
    t0 = time.perf_counter()
    out["pp_eval"] = trainer.evaluate(iter(batches), len(batches))["eval_loss"]
    out["pp_eval_s"] = time.perf_counter() - t0
    if m.is_main:
        t0 = time.perf_counter()
        params, step = load_params(save_dir)
        one = Trainer(dataclasses.replace(cfg, mesh=MeshConfig(dp=1)), device=dev)
        one.load_params(params)
        out["pp1_load_s"] = time.perf_counter() - t0
        out["pp1_load_bitwise"] = step == trainer.step_count and all(
            torch.equal(one.params[n].detach(), whole[n].to(dev)) for n in whole)
        total = count = 0.0
        with torch.no_grad():
            for b in batches:
                s, c = lm_eval_sums(one.model, b)
                total, count = total + float(s), count + float(c)
        out["pp1_eval"] = total / count
        del one, params
        torch.cuda.empty_cache()
    m.barrier()
    return out


def pp_verdict(label, ranks):
    """The pp readings beyond ``dp_train_verdict``'s: the leaves every stage
    holds bitwise on every rank, each rank's wait on its neighbour beside the
    bubble, and (c) where it ran. Raises where a check fails."""
    r0 = ranks[0]
    n_micro, pp = r0["n_micro"], r0["mesh"][4]
    bubble = (pp - 1) / (n_micro + pp - 1)
    waits = [[round(s["collective_ms"]["p2p_recv"] / s["ms"], 4) for s in r["steps"]]
             for r in ranks]
    log(f"pp {label}: n_micro {n_micro} ({'full' if r0['full_manual'] else 'partial'}-manual), "
        f"bubble (pp - 1) / (n_micro + pp - 1) = {bubble:.4f}; each rank's share of a step "
        f"spent waiting on its neighbour, by step: {waits}; the leaves every stage holds "
        f"bitwise on every rank: {len({r['trunk_digest'] for r in ranks}) == 1}")
    if len({r["trunk_digest"] for r in ranks}) != 1:
        raise AssertionError(f"pp {label}: the leaves every stage holds differ between ranks")
    if "pp_save_s" in r0:
        log(f"pp {label} (c): the pp=1 file saved in {r0['pp_save_s']:.1f} s; a pp=1 Trainer's "
            f"load of its params ({r0['pp1_load_s']:.1f} s) bitwise the gathered params "
            f"{r0['pp1_load_bitwise']}; eval loss of {PP_EVAL_BATCHES} batches, "
            f"orion_tpu_torch.evaluate on the loaded model {r0['pp1_eval']:.6f} against the pp "
            f"Trainer's {[round(r['pp_eval'], 6) for r in ranks]} ({r0['pp_eval_s']:.1f} s; "
            f"limit {PP_EVAL_ATOL})")
        if not r0["pp1_load_bitwise"] or any(abs(r["pp_eval"] - r0["pp1_eval"]) > PP_EVAL_ATOL
                                             for r in ranks):
            raise AssertionError(f"pp {label} (c) misses: {r0}")


def pp_verdicts(two, four):
    """The pp part's verdicts on the spawns' results (``two``: the 2-rank
    spawn's, each rank's {"pp_train": ...}; ``four``: the 4-rank spawn's
    ``dp_train_rank`` results): (a), (b) and (c) (``dp_train_verdict``,
    ``pp_verdict``), (a)'s peak memory below the twin's. Returns (each
    kernel's launches over the part's training steps and ranks, by
    ``KERNELS`` name and by the sp entries' names; the readings)."""
    train2 = [r["pp_train"] for r in two]
    labels4 = [_mesh_label(name, shape) for name, _, _, meshes in PP_TRAIN_4 for shape in meshes]
    four = [{label: r[label] for label in labels4} for r in four]
    for label in train2[0]:
        ranks = [r[label] for r in train2]
        dp_train_verdict(label, ranks)
        pp_verdict(label, ranks)
        twin_peak = ranks[0]["twin"]["twin_peak_gib"]
        peaks = [r["peak_gib"] for r in ranks]
        log(f"pp {label}: peak memory a rank {[round(p, 2) for p in peaks]} GiB against the "
            f"pp=1 twin's {twin_peak:.2f} GiB ({[round(p / twin_peak, 3) for p in peaks]}); "
            f"resident params + AdamW state a rank {[r['held'] for r in ranks]} bytes")
        if not all(p < twin_peak for p in peaks):
            raise AssertionError(f"pp {label}: a rank's peak memory {peaks} GiB is not below the "
                                 f"pp=1 twin's {twin_peak:.2f} GiB")
    for label in labels4:
        ranks = [r[label] for r in four]
        dp_train_verdict(label, ranks)
        pp_verdict(label, ranks)
    launches = _mesh_launches(train2 + four)
    missing = [k for k in PP_PATH if not launches.get(k)]
    log(f"pp part: launches over its runs: {launches}")
    if missing:
        raise AssertionError(f"the pp part launched no {missing}")
    readings = {label: [{k: r[label][k] for k in ("peak_gib", "held", "transport", "n_micro")}
                        for r in rs] for rs in (train2, four) for label in rs[0]}
    return launches, readings


def pp_phase(dev):
    """The pp part alone (``mesh_parts``)."""
    return mesh_parts(dev, ("pp",))["pp"]


# ---------------------------------------------------------------------------
# Generate on a mesh (A12 steps 6 and 6b): the port's ``generate`` on the
# meshes the JAX CLI takes, ranks sharing the card over gloo
# ---------------------------------------------------------------------------

# Each run: (label, config, overrides, mesh sizes, prompts (B, T), quant),
# 4 prompts at full width with the weights cast for inference (or quantized
# on the mesh: whole leaves quantized, then cut), against the one-rank twin
# with the same weights on this rank's card. On the 2-rank spawn: G1, lm_1b3
# at 4 blocks (24 until the combos part took its time), sp 2, 4 x 1024 (row
# 1 in its parts form on token shards); G2, lm_1b3 at 4 blocks at dp 2 and at
# fsdp 2 (2 of the 4 rows a rank; fsdp gathers each block's leaves at the
# prefill and at every decode step, through host memory under gloo: ~5 s a
# step at full depth, so its decode is cut to ``GENMESH_FSDP_NEW`` tokens),
# and the dropless
# moe_1b3_4e at 4 blocks at dp 2 (row 9 on a data rank's 2 x 1024 rows);
# G3, hybrid_1b3 at 4 blocks
# (swa, softmax, swa, linear; striped ring) at sp 2 on 4 x 1536: row 6 in
# the striped ring (shift) and in the halo (q_offset) of a prefill. On the
# 4-rank spawn, G4 at 4 blocks: lm_1b3 at sp 4 on 1021 tokens (padded to
# 1024: the padded path) and at int8 and int4 at dp 2 x tp 2 (row 14 on the
# tp shards: wq..wv out 1024, wo in 1024, gate / up out 2752, down in 2752).
#
# Each run reads, on every rank: the twin's tokens teacher-forced through
# the mesh model (the twin runs this rank's rows, so a data rank's run is
# the one-rank run of its rows): each step's logits within
# ``TP_LOGITS_ATOL`` of the twin's, every layer's state after the prefill and
# after the last step within ``TP_S_RTOL`` / ``TP_KV_RTOL`` of the twin's
# (this rank's rows and heads; the whole sequence's under sp), every launch
# of rows 1, 6, 9 and 14 in that run held against its plain version
# (``LaunchAudit``, the kernel checks' limits); then the free-running
# greedy and sampled (temperature 0.8) tokens against the twin's at the
# whole batch (matches counted: a reading), the tokens bitwise on every
# rank, the logits bitwise on the ranks that share rows, exact launches,
# prefill and decode ms a rank, host ms in the collectives and peak and
# resident memory a rank beside the twin's. The limits are tp's (c): the
# mesh paths round where tp does (each rank's partial wo / down outputs in
# bf16 before their fp32 sum) or less (sp's prefix sums and state totals
# run in fp32; dp and fsdp run the one-rank products on fewer rows), and a
# wrong shard, head, row or sum moves them by the values' own size.
GENMESH_NEW = 16
GENMESH_FSDP_NEW = 2
GENMESH_SAMPLE = dict(temperature=0.8)
GENMESH_SEED = 7
GENMESH_DEPTH = {"n_layers": 4}
GENMESH_HYBRID = {"n_layers": 4, "layer_types": ("swa", "softmax", "swa", "linear"),
                  "ring_striped": True}
GENMESH_2 = (
    ("G1 lm_1b3 (4 blocks) at sp 2", "lm_1b3", GENMESH_DEPTH, dict(sp=2), (4, 1024), ""),
    ("G2 lm_1b3 (4 blocks) at dp 2", "lm_1b3", GENMESH_DEPTH, dict(dp=2), (4, 1024), ""),
    ("G2 lm_1b3 (4 blocks) at fsdp 2", "lm_1b3", GENMESH_DEPTH, dict(fsdp=2), (4, 1024), ""),
    ("G2 moe_1b3_4e (dropless, 4 blocks) at dp 2", "moe_1b3_4e",
     {**GENMESH_DEPTH, "moe_dropless": True}, dict(dp=2), (4, 1024), ""),
    ("G3 hybrid_1b3 (4 blocks) at sp 2", "hybrid_1b3", GENMESH_HYBRID, dict(sp=2), (4, 1536), ""),
)
GENMESH_4 = (
    ("G4 lm_1b3 (4 blocks) at sp 4, 1021 tokens", "lm_1b3", GENMESH_DEPTH, dict(sp=4),
     (4, 1021), ""),
    ("G4 lm_1b3 (4 blocks) int8 at dp 2 x tp 2", "lm_1b3", GENMESH_DEPTH, dict(dp=2, tp=2),
     (4, 1024), "int8"),
    ("G4 lm_1b3 (4 blocks) int4 at dp 2 x tp 2", "lm_1b3", GENMESH_DEPTH, dict(dp=2, tp=2),
     (4, 1024), "int4"),
)
# the kernels the genmesh part must launch (every one of its path)
GENMESH_PATH = ("causal_dot_norm_wgmma", "flash_fwd_wgmma", "gmm_fwd_wgmma", "q4_matmul_mma")


def genmesh_expected_launches(cfg, m, t_loc, rows, quant, prefills, steps):
    """The exact launches of ``prefills`` prefills and ``steps`` decode steps
    of the model at ``cfg`` on this rank of mesh ``m`` (``t_loc``: a
    prefill's tokens on this rank, ``rows``: its rows): row 1 once a linear
    layer and prefill (the parts form under sp), row 6 once a softmax / swa
    layer and prefill, or under sp the striped ring's sp calls a softmax
    layer (``shift`` 1 on the sp - 1 - s from later ranks) and the halo's
    1 + min(s, h) a swa layer (``q_offset`` on min(s, h)); row 9 once a
    dropless MoE layer's product and prefill of at least ``GMM_MIN_ROWS``
    routed rows; row 14 once an int4 layer and decode step. All wgmma / mma:
    bf16 at D 128 and widths the mma variant takes. -> (the ``KERNELS``
    counts, the flash calls with shift or q_offset)."""
    from orion_tpu_torch.models.moe import GMM_MIN_ROWS

    lin, attn, _, _ = _layer_counts(cfg)
    want = dict.fromkeys(KERNELS, 0)
    want["causal_dot_norm_wgmma"] = prefills * lin
    offset_calls = 0
    if m.sp > 1 and attn:
        s = m.sp_rank
        calls = 0
        for lt in cfg.resolved_layer_types:
            if lt == "softmax":
                calls, offset_calls = calls + m.sp, offset_calls + (m.sp - 1 - s)
            elif lt == "swa":
                h = min(-(-(cfg.window - 1) // t_loc), m.sp - 1)
                calls, offset_calls = calls + 1 + min(s, h), offset_calls + min(s, h)
        want["flash_fwd_wgmma"] = prefills * calls
        offset_calls *= prefills
    else:
        want["flash_fwd_wgmma"] = prefills * attn
    if rows * t_loc * max(cfg.moe_top_k, 1) >= GMM_MIN_ROWS and not quant:
        want["gmm_fwd_wgmma"] = prefills * _gmm_counts(cfg)[0]
    if quant == "int4":
        want["q4_matmul_mma"] = steps * _q4_per_step(cfg)
    return want, offset_calls


def _held_bytes(model):
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def genmesh_run(mesh, run, mods, device=None):
    """One run of the genmesh part on this rank (the comment above
    ``GENMESH_NEW``) -> its readings."""
    from orion_tpu_torch.generate import (SampleConfig, cast_params_for_inference, generate,
                                          prefill_prompt, quantize_for_decode, sp_multiple)
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.parallel.collectives import _gather_cat
    from orion_tpu_torch.parallel.mesh import MeshConfig

    label, name, over, sizes, (b, t), quant, *pinned = run
    dev = mesh.device
    m = _remesh(mesh, MeshConfig(**{"dp": 1, **sizes}), device)
    # a MoE's teacher-forced runs on the twin's expert choices (the combos
    # part's M2: a near-tie flipped by the sp prefill's roundings moves a
    # token's whole contribution to another expert)
    pin = ShardPinnedRouting(t, m.sp, m.sp_rank) if pinned and pinned[0] == "pin" else None
    cfg = get_config(name, **over)
    new = GENMESH_FSDP_NEW if m.fsdp > 1 else GENMESH_NEW
    greedy, sampled_cfg = SampleConfig(temperature=0.0), SampleConfig(**GENMESH_SAMPLE)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (b, t), dtype=np.int64)).to(dev)
    split = m.n_data > 1 and b % m.n_data == 0
    rows = (torch.from_numpy(m.row_index(b)).to(dev) if split
            else torch.arange(b, device=dev))
    heads = cfg.n_heads // m.tp
    lo = m.tp_rank * heads

    def build(on):
        model = TransformerLM(dataclasses.replace(cfg, sequence_parallel=on is not None
                                                  and on.sp > 1), device=dev, mesh=on)
        return quantize_for_decode(model, quant) if quant else cast_params_for_inference(model)

    def mine(states):  # this rank's heads of the twin's states (of this rank's rows)
        return [{k: v[:, lo:lo + heads].clone() for k, v in st.items()} for st in states]

    gc.collect()
    torch.cuda.empty_cache()
    twin = build(None)
    twin_held = _held_bytes(twin)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode(), pin if pin is not None else contextlib.nullcontext():
        if pin is not None:
            pin.attach(twin)
        logits, states = twin.prefill_last(prompts[rows])
        ref_logits, tokens, ref_first = [logits], [logits.argmax(-1)], mine(states)
        for i in range(new - 1):
            logits, states = twin.decode_step(tokens[-1], states, t + i)
            ref_logits.append(logits)
            tokens.append(logits.argmax(-1))
        ref_last = mine(states)
        del states, logits
    twin_prefill_ms, _ = wall_ms(lambda: generate(twin, prompts, 1, greedy))
    twin_gen_ms, twin_free = wall_ms(lambda: generate(twin, prompts, new, greedy))
    twin_sampled = generate(twin, prompts, new, sampled_cfg, GENMESH_SEED)
    twin_peak = torch.cuda.max_memory_allocated(dev)
    del twin
    gc.collect()
    torch.cuda.empty_cache()

    model = build(m)
    held = _held_bytes(model)
    torch.cuda.reset_peak_memory_stats(dev)
    fa = mods[1]
    m.barrier()
    with torch.inference_mode():
        _reset_counts(mods)
        fa.launches_fwd_sp = 0
        with LaunchAudit(mods, (1, 6, 9, 14)) as audit, \
                pin if pin is not None else contextlib.nullcontext():
            if pin is not None:
                pin.attach(model)
                pin.restart()
            t0 = time.perf_counter()
            logits, states = prefill_prompt(model, prompts[rows])
            got, first_err = [logits], _state_err(states, ref_first)
            for i in range(new - 1):
                logits, states = model.decode_step(tokens[i], states, t + i)
                got.append(logits)
            torch.cuda.synchronize()
            forced_ms = (time.perf_counter() - t0) * 1e3
            last_err = _state_err(states, ref_last)
            del states, logits
        clock = _collective_clock()
        before = clock["dist"]
        prefill_ms, _ = wall_ms(lambda: generate(model, prompts, 1, greedy))
        prefill_clock = clock["dist"] - before
        gen_ms, free = wall_ms(lambda: generate(model, prompts, new, greedy))
        gen_clock = clock["dist"] - before - prefill_clock
        sampled = generate(model, prompts, new, sampled_cfg, GENMESH_SEED)
        counts, offset_calls = _counts(mods), fa.launches_fwd_sp
    peak = torch.cuda.max_memory_allocated(dev)
    full = -(-t // sp_multiple(model)) * sp_multiple(model)
    want, want_offset = genmesh_expected_launches(cfg, m, full // m.sp if m.sp > 1 else t,
                                                  len(rows), quant, 4, 3 * (new - 1))
    # the logits of the ranks that share rows: bitwise (one gather over the world)
    digest = _logits_digest(got)
    digests = _gather_cat(torch.tensor([[m.data_rank, digest]], device=dev), 0, None).tolist()
    same = (free == twin_free).cpu()
    out = {
        "label": label, "mesh": sizes, "rank": m.rank, "coords": m.coords, "new": new,
        "rows": rows.tolist(), "transport": m.transport,
        "logits_err": [float((a - r).abs().max()) for a, r in zip(got, ref_logits)],
        "logits_bitwise": all(torch.equal(a, r) for a, r in zip(got, ref_logits)),
        "finite": all(bool(torch.isfinite(a).all()) for a in got),
        "s_err": (first_err[0], last_err[0]), "kv_err": (first_err[1], last_err[1]),
        "digests": digests, "tokens_digest": _logits_digest([free, sampled]),
        "free_match": int(same.sum()), "free_of": same.numel(),
        "free_prefix": [int(r.logical_not().nonzero()[0]) if not r.all() else new for r in same],
        "sampled_match": int((sampled == twin_sampled).sum()),
        "sampled_bitwise": bool(torch.equal(sampled, twin_sampled)),
        "counts": counts, "want": want, "offset_calls": offset_calls,
        "want_offset": want_offset, "audit": audit.reading(),
        "forced_ms": forced_ms, "prefill_ms": prefill_ms,
        "flips": (pin.flips, pin.choices) if pin is not None else None,
        "decode_ms_per_step": (gen_ms - prefill_ms) / max(new - 1, 1),
        "twin_prefill_ms": twin_prefill_ms,
        "twin_decode_ms_per_step": (twin_gen_ms - twin_prefill_ms) / max(new - 1, 1),
        "collective_ms": {"prefill": prefill_clock, "generate": gen_clock},
        "peak_gib": peak / 2**30, "twin_peak_gib": twin_peak / 2**30,
        "held_gib": held / 2**30, "twin_held_gib": twin_held / 2**30,
    }
    del model, got, ref_logits, ref_first, ref_last
    gc.collect()
    torch.cuda.empty_cache()
    m.barrier()
    return out


def genmesh_rank(mesh, payload):
    """One rank of the genmesh part: each run of ``payload["genmesh"]`` on
    its own mesh of the spawn's group, in order -> {label: readings}."""
    from orion_tpu_torch.ops.kernels import adafactor, causal_dot, flash_attention, gmm, q4_matmul

    mods = (causal_dot, flash_attention, gmm, q4_matmul, adafactor)
    return {run[0]: genmesh_run(mesh, run, mods, payload.get("device"))
            for run in payload["genmesh"]}


def genmesh_verdict(label, ranks):
    """Log one genmesh run's readings (every rank's); raise where a limit is
    missed, a launch of rows 1, 6, 9, 14 disagrees with its plain version, a
    launch count is off, or the ranks' tokens (or the logits of ranks that
    share rows) differ."""
    r0 = ranks[0]
    audit = {}
    for r in ranks:
        for k, v in r["audit"]["worst"].items():
            audit[k] = max(audit.get(k, 0.0), v)
    shapes = sorted({s for r in ranks for ss in r["audit"]["shapes"].values() for s in ss})
    log(f"genmesh {label} (transport {r0['transport']}): teacher-forced logits against the "
        f"one-rank twin, max abs a step up to {max(max(r['logits_err']) for r in ranks):.4e} "
        f"(limit {TP_LOGITS_ATOL}; bitwise on ranks {[r['rank'] for r in ranks if r['logits_bitwise']]}); "
        f"states max rel after the prefill / the last step: S {[r['s_err'] for r in ranks]} "
        f"(limit {TP_S_RTOL:g}), K/V {[r['kv_err'] for r in ranks]} (limit {TP_KV_RTOL:g}); "
        f"free-running greedy tokens equal to the twin's {r0['free_match']} of {r0['free_of']} "
        f"(first miss a row {r0['free_prefix']}); sampled (temperature 0.8) "
        f"{r0['sampled_match']} of {r0['free_of']} (bitwise {r0['sampled_bitwise']})")
    log(f"genmesh {label}: prefill {[round(r['prefill_ms'], 2) for r in ranks]} ms, decode "
        f"{[round(r['decode_ms_per_step'], 3) for r in ranks]} ms/step a rank against the twin's "
        f"{r0['twin_prefill_ms']:.2f} ms, {r0['twin_decode_ms_per_step']:.3f} ms/step; host ms "
        f"in the collectives (prefill, {r0['new']}-token generate) "
        f"{[(round(r['collective_ms']['prefill'], 1), round(r['collective_ms']['generate'], 1)) for r in ranks]}; "
        f"peak {[round(r['peak_gib'], 2) for r in ranks]} GiB against the twin's "
        f"{r0['twin_peak_gib']:.2f}, resident weights {[round(r['held_gib'], 3) for r in ranks]} "
        f"GiB against {r0['twin_held_gib']:.3f}")
    log(f"genmesh {label}: every launch of rows 1, 6, 9, 14 in the teacher-forced run held "
        f"against its plain version ({[r['audit']['launches'] for r in ranks]}), largest share "
        f"of its limit { {k: float(f'{v:.3g}') for k, v in audit.items()} }; shapes {shapes}; "
        f"launches a rank {[{k: v for k, v in r['counts'].items() if v} for r in ranks]}, calls "
        f"with shift / q_offset {[r['offset_calls'] for r in ranks]}")
    for r in ranks:
        if r["counts"] != r["want"] or r["offset_calls"] != r["want_offset"]:
            raise AssertionError(f"genmesh {label} rank {r['rank']}: launches {r['counts']} "
                                 f"({r['offset_calls']} with shift / q_offset), want "
                                 f"{r['want']} ({r['want_offset']})")
        missed = (not r["finite"] or max(r["logits_err"]) > TP_LOGITS_ATOL
                  or max(e or 0.0 for e in r["s_err"]) > TP_S_RTOL
                  or max(e or 0.0 for e in r["kv_err"]) > TP_KV_RTOL)
        if missed:
            raise AssertionError(f"genmesh {label} rank {r['rank']} misses its limits against "
                                 f"the one-rank twin: {r}")
    if not audit or any(v > 1.0 or not np.isfinite(v) for v in audit.values()):
        raise AssertionError(f"genmesh {label}: a launch disagrees with its plain version: "
                             f"{audit}")
    if len({r["tokens_digest"] for r in ranks}) != 1:
        raise AssertionError(f"genmesh {label}: the ranks' tokens differ")
    by_rows = {}
    for data_rank, digest in r0["digests"]:
        by_rows.setdefault(data_rank, set()).add(digest)
    if any(len(d) != 1 for d in by_rows.values()):
        raise AssertionError(f"genmesh {label}: the logits of ranks that share rows differ: "
                             f"{r0['digests']}")


def genmesh_verdicts(two, four):
    """The genmesh part's verdicts on the spawns' results (each rank's
    {label: readings}). Returns (each kernel's launches over the part's runs
    and ranks, by ``KERNELS`` name; the readings by label)."""
    launches = dict.fromkeys(KERNELS, 0)
    readings = {}
    for spawn in (two, four):
        for label in spawn[0]:
            ranks = [r[label] for r in spawn]
            genmesh_verdict(label, ranks)
            for r in ranks:
                for k in KERNELS:
                    launches[k] += r["counts"][k]
            readings[label] = [{k: r[k] for k in (
                "prefill_ms", "decode_ms_per_step", "twin_prefill_ms", "twin_decode_ms_per_step",
                "collective_ms", "peak_gib", "twin_peak_gib", "held_gib", "twin_held_gib",
                "free_match", "free_of", "sampled_match", "sampled_bitwise", "logits_bitwise",
                "transport")} for r in ranks]
    missing = [k for k in GENMESH_PATH if not launches.get(k)]
    log(f"genmesh part: launches over its runs: { {k: v for k, v in launches.items() if v} }")
    if missing:
        raise AssertionError(f"the genmesh part launched no {missing}")
    return launches, readings


def genmesh_phase(dev):
    """The genmesh part alone (``mesh_parts``)."""
    return mesh_parts(dev, ("genmesh",))["genmesh"]


# -- the combos part: the mesh combinations A12 step 7 ported ------------------------------
#
# Ranks of this script sharing the card over gloo, inside the mesh parts'
# 2-rank and 4-rank spawns, each run against its one-rank twin at the
# limits of the part it extends. (M1, 2 ranks) the dropless moe_1b3_4e at 4
# blocks (block 3 the MoE: d 2048, 4 experts, hidden 5504), trained 2 steps
# at sp 2 on B 4 x 2048: each rank routes its 4 x 1024 tokens, 4096 rows at
# top-1 (4608 with the tile padding), through rows 9 and 10; the dp part's readings and limits against
# the twin replaying the mesh run's routing (gathered over sp in token
# order), exact launches a step (the sp part's counts of rows 1, 3, 4 and the
# dp part's of rows 9-10), and every launch of rows 1, 3, 4, 9 and 10 held
# against its plain version. (M2, 2 ranks) ``generate`` at sp 2 on the same
# MoE, 4 prompts of 1024: the genmesh part's G1 readings and limits, the
# teacher-forced runs on the twin's expert choices (``ShardPinnedRouting``).
# (M3, 4 ranks) lm_1b3 at 4 blocks with ``dropout=0.1`` at dp 2 x tp 2 and
# sp 2 x dp 2, B 8 x 1024, 2 steps: the dp / sp readings and limits against
# the one-rank twin, and every mask each rank draws bitwise the twin's at
# its rows and tokens (``MaskTap``), every recomputation redrawing its
# mask. (M4, 2 ranks) ``train_lra`` of lra_text_linear at LRA's length, B 16
# x 4000, fp32, 4 steps at dp 2 against the one-rank run from the same seed:
# each step's loss within ``LRA_ATOL_OF_MAX`` of max(1, |loss|), the final
# params within ``LRA_ATOL_OF_MAX`` of max(1, each leaf's largest), the eval
# accuracy equal, and no kernel launched (the classifier's attention is
# plain torch).
COMBOS_DEPTH = {"n_layers": 4, "remat_skip": 2}
COMBOS_TRAIN_2 = (
    ("moe_1b3_4e", {**COMBOS_DEPTH, "moe_dropless": True, "sequence_parallel": True},
     dict(steps=2, batch_size=4, seq_len=2048, warmup_steps=1), ((1, 1, 2),),
     {"audit": (1, 3, 4, 9, 10), "label": "M1"}),
)
COMBOS_GENERATE = (
    ("M2 moe_1b3_4e (dropless, 4 blocks) at sp 2", "moe_1b3_4e",
     {**GENMESH_DEPTH, "moe_dropless": True}, dict(sp=2), (4, 1024), "", "pin"),
)
COMBOS_TRAIN_4 = (
    ("lm_1b3", {**COMBOS_DEPTH, "dropout": 0.1, "sequence_parallel": True}, DP_TRAIN,
     ((2, 1, 2, 1), (2, 1, 2)), {"masks": True, "label": "M3"}),
)
COMBOS_LRA = ("M4 lra_text_linear at dp 2", "lra_text_linear", 4000, 16, 4)
# the kernels the combos part must launch (rows 1, 3, 4, 9 and 10 on the sp
# shards; the sp parts' entries under their own names)
COMBOS_PATH = ("causal_dot_norm_wgmma", "causal_dot_dq_den_wgmma", "causal_dot_rev_den_wgmma",
               "gmm_fwd_wgmma", "gmm_dw_wgmma")


def combos_lra_rank(mesh, run, mods, device=None):
    """M4 on this rank: the one-rank ``train_lra`` on rank 0 (the others
    wait), then the dp 2 run on every rank -> readings (rank 0's against the
    one-rank run)."""
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.parallel.mesh import MeshConfig
    from orion_tpu_torch.train_lra import LRATrainConfig, train_lra

    label, name, seq_len, batch, steps = run
    m = _remesh(mesh, MeshConfig(dp=2), device)
    cfg = LRATrainConfig(model=get_config(name, max_seq_len=seq_len + 8), task="text",
                         steps=steps, batch_size=batch, seq_len=seq_len, log_every=1,
                         eval_every=steps, eval_batches=2, seed=0)
    twin = None
    if m.is_main:
        clock = StepClock()
        params, last = train_lra(cfg, clock, device=m.device)
        twin = ([c["loss"] for c in clock.metrics], clock.times, last,
                {n: t.detach().to("cpu", copy=True) for n, t in params.items()})
        del params
    m.barrier()
    gc.collect()
    _reset_counts(mods)
    clock = StepClock()
    params, last = train_lra(dataclasses.replace(cfg, mesh=m.cfg), clock, mesh=m)
    launched = {k: v for k, v in _counts(mods).items() if v}
    out = {"label": label, "rank": m.rank, "transport": m.transport, "launched": launched,
           "eval_acc": last["eval_acc"], "finite": all(bool(torch.isfinite(p).all())
                                                      for p in params.values())}
    if m.is_main:
        losses = [c["loss"] for c in clock.metrics]
        t_losses, t_times, t_last, t_params = twin
        out.update(losses=losses, twin_losses=t_losses, twin_eval_acc=t_last["eval_acc"],
                   step_ms=[1e3 * (b - a) for a, b in zip(clock.times, clock.times[1:])],
                   twin_step_ms=[1e3 * (b - a) for a, b in zip(t_times, t_times[1:])],
                   loss_err=max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(losses, t_losses)),
                   param_err=max(float((params[n].cpu() - t).abs().max())
                                 / max(1.0, float(t.abs().max())) for n, t in t_params.items()))
    del params
    m.barrier()
    return out


def combos_rank(mesh, payload):
    """One rank of the combos part: the training runs of ``payload["runs"]``
    (``dp_train_rank`` with their options), then on 2 ranks M2
    (``genmesh_run``) and M4 (``combos_lra_rank``) -> {"train", "generate",
    "lra"}."""
    from orion_tpu_torch.ops.kernels import adafactor, causal_dot, flash_attention, gmm, q4_matmul

    mods = (causal_dot, flash_attention, gmm, q4_matmul, adafactor)
    out = {"train": dp_train_rank(mesh, payload)}
    if payload.get("generate"):
        out["generate"] = {run[0]: genmesh_run(mesh, run, mods, payload.get("device"))
                           for run in payload["generate"]}
    if payload.get("lra"):
        out["lra"] = combos_lra_rank(mesh, payload["lra"], mods, payload.get("device"))
    return out


def combos_train_verdict(label, ranks, opts):
    """``dp_train_verdict``, then the combos options' readings: the audit
    (every launch of its rows within its kernel limit, each row launched),
    the masks (every rank's draws bitwise the twin's slices, no missing key,
    every recomputation equal), the gmm launches of a MoE under sp."""
    dp_train_verdict(label, ranks)
    tag = opts.get("label", "")
    if opts.get("audit"):
        worst, launched = {}, {}
        for r in ranks:
            for k, v in r["audit"]["worst"].items():
                worst[k] = max(worst.get(k, 0.0), v)
            for k, v in r["audit"]["launches"].items():
                launched[k] = launched.get(k, 0) + v
        shapes = sorted({s for r in ranks for ss in r["audit"]["shapes"].values() for s in ss})
        log(f"combos {tag} {label}: every launch of rows {opts['audit']} held against its plain "
            f"version ({launched}), largest share of its limit "
            f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }; shapes {shapes}")
        rows = {f"row {r}" for r in opts["audit"]}
        if set(launched) != rows or any(v > 1.0 or not np.isfinite(v) for v in worst.values()):
            raise AssertionError(f"combos {tag} {label}: a launch disagrees with its plain version "
                                 f"or a row did not launch: {launched}, {worst}")
    for r, res in enumerate(ranks):
        if "want_gmm" in res:
            got = [{k: c[k] for k in res["want_gmm"]} for c in res["per_step"]]
            if any(g != res["want_gmm"] for g in got):
                raise AssertionError(f"combos {tag} {label} rank {r}: gmm launches {got}, want "
                                     f"{res['want_gmm']} a step")
    if opts.get("masks"):
        mk = ranks[0]["masks"]
        log(f"combos {tag} {label}: dropout masks, {mk['compared']} draws of the ranks against "
            f"the twin's {mk['keys']} (block, site) masks cut at their rows and tokens, "
            f"{mk['equal']} bitwise equal, {mk['missing']} keys the twin never drew; "
            f"recomputations {mk['redraws']} equal, {mk['differs']} not")
        if not mk["compared"] or mk["equal"] != mk["compared"] or mk["missing"] or \
                mk["differs"] or not mk["redraws"]:
            raise AssertionError(f"combos {tag} {label}: the masks are not the twin's: {mk}")


def combos_lra_verdict(ranks):
    """M4's readings (every rank's); raise where a limit is missed."""
    r0 = ranks[0]
    log(f"combos {r0['label']} (transport {r0['transport']}): step losses {r0['losses']} vs the "
        f"one-rank run's {r0['twin_losses']} (largest error {r0['loss_err']:.3e} of max(1, "
        f"|loss|), limit {LRA_ATOL_OF_MAX:g}); final params within {r0['param_err']:.3e} of "
        f"max(1, each leaf's largest) (limit {LRA_ATOL_OF_MAX:g}); eval accuracy "
        f"{[r['eval_acc'] for r in ranks]} vs {r0['twin_eval_acc']}; step ms "
        f"{[round(x, 1) for x in r0['step_ms']]} vs {[round(x, 1) for x in r0['twin_step_ms']]}; "
        f"kernel launches {[r['launched'] for r in ranks]}")
    if r0["loss_err"] > LRA_ATOL_OF_MAX or r0["param_err"] > LRA_ATOL_OF_MAX or any(
            r["eval_acc"] != r0["twin_eval_acc"] or r["launched"] or not r["finite"]
            for r in ranks):
        raise AssertionError(f"combos {r0['label']} misses its limits against the one-rank run: "
                             f"{r0}")


def combos_verdicts(two, four):
    """The combos part's verdicts on the spawns' results (each rank's
    ``combos_rank`` result). Returns (each kernel's launches over the part's
    runs and ranks, by ``KERNELS`` name and the sp entries' names; the
    readings)."""
    launches = dict.fromkeys(KERNELS, 0)
    readings = {}
    for spawn, runs in ((two, COMBOS_TRAIN_2), (four, COMBOS_TRAIN_4)):
        for name, _, _, meshes, opts in runs:
            for shape in meshes:
                label = _mesh_label(name, shape)
                ranks = [r["train"][label] for r in spawn]
                combos_train_verdict(label, ranks, opts)
                readings[f"{opts['label']} {label}"] = [
                    {k: r[k] for k in ("peak_gib", "held", "transport")} for r in ranks]
        _mesh_launches([r["train"] for r in spawn], launches)
    for label in two[0]["generate"]:
        ranks = [r["generate"][label] for r in two]
        genmesh_verdict(label, ranks)
        log(f"combos {label}: routing choices the teacher-forced runs replayed from the twin, "
            f"flipped / made a rank {[r['flips'] for r in ranks]}")
        for r in ranks:
            for k in KERNELS:
                launches[k] += r["counts"][k]
        readings[label] = [{k: r[k] for k in ("prefill_ms", "decode_ms_per_step",
                                              "twin_prefill_ms", "free_match", "free_of",
                                              "flips")} for r in ranks]
    lra = [r["lra"] for r in two]
    combos_lra_verdict(lra)
    readings[lra[0]["label"]] = {k: lra[0][k] for k in ("loss_err", "param_err", "step_ms",
                                                        "twin_step_ms")}
    missing = [k for k in COMBOS_PATH if not launches.get(k)]
    log(f"combos part: launches over its runs: { {k: v for k, v in launches.items() if v} }")
    if missing:
        raise AssertionError(f"the combos part launched no {missing}")
    return launches, readings


def dropout_cost(dev, shape=(8, 1024, 2048), rate=0.1):
    """One dropout mask at lm_1b3's training shape on the card, in three
    forms: ``dropout_keep`` (the int32 hash, ``utils/rng.py``'s
    ``counter_below``), the same keys through the int64 ``counter_bits``
    (which must give the same mask bitwise, else AssertionError), and a
    ``torch.rand`` draw of the shape and its compare (the rank-shaped draw
    dropout took before masks were keyed by position). For each: its ms
    (CUDA events, 20 calls after a warm-up) and the memory it takes beyond
    its bool mask while it is drawn (the peak above the allocated bytes
    before the call) -> a reading, logged. A mask a block site; lm_1b3's
    step draws 2 x 24, and 2 x 20 again in the recomputation."""
    from orion_tpu_torch.models.transformer import DropoutKey, dropout_keep
    from orion_tpu_torch.utils import rng as rngs

    key, (b, t, d) = DropoutKey(123, 0, 0), shape
    bound = round((1.0 - rate) * 2 ** 32)

    def int64_form():
        k = torch.tensor(rngs.key_words(rngs.fold(key.seed, 1)), dtype=torch.int64, device=dev)
        k = rngs.fold_keys(k, torch.arange(b, device=dev))
        k = rngs.fold_keys(k[:, None], torch.arange(t, device=dev))
        return rngs.counter_bits(k, d) < bound

    gen = torch.Generator(device=dev).manual_seed(123)
    forms = {"int32": lambda: dropout_keep(key, 1, shape, rate, dev), "int64": int64_form,
             "rand": lambda: torch.rand(shape, generator=gen, device=dev) < 1.0 - rate}
    out, masks = {"shape": list(shape)}, {}
    for name, fn in forms.items():
        fn()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        masks[name] = fn()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(dev) - before - masks[name].numel()
        ms = cuda_ms(fn, 20)
        out[name] = {"ms": ms, "transient_gib": extra / 2**30,
                     "keep_share": float(masks[name].float().mean()),
                     "per_step_ms": ms * 2 * (24 + 20)}
    if not torch.equal(masks["int32"], masks["int64"]):
        raise AssertionError("dropout_keep's int32 hash differs from the int64 counter_bits")
    log(f"dropout mask at {list(shape)} (lm_1b3's training shape; 88 masks a full-depth step: "
        f"2 sites x 24 blocks, 20 recomputed): " + "; ".join(
            f"{n} {r['ms']:.4f} ms a mask, {r['transient_gib']:.3f} GiB transient beyond the "
            f"mask, keep share {r['keep_share']:.6f}, {r['per_step_ms']:.1f} ms a step"
            for n, r in ((n, out[n]) for n in forms)) + " (int32 bitwise int64)")
    del masks
    return out


def combos_phase(dev):
    """The combos part alone (``mesh_parts``), after the dropout mask's cost
    (``dropout_cost``)."""
    dropout_cost(dev)
    return mesh_parts(dev, ("combos",))["combos"]


# -- the mesh parts' spawns --------------------------------------------------------------


def two_rank(mesh, payload):
    """One rank of the 2-rank spawn: the tp part's (a) and (c) on the
    spawn's tp mesh, the pp part's (a) and (c) (``dp_train_rank`` remeshes
    to pp 2), the genmesh part's ``GENMESH_2``, the combos part's M1, M2 and
    M4, as ``payload["parts"]`` asks."""
    out = {}
    if "genmesh" in payload["parts"]:
        out["genmesh"] = genmesh_rank(mesh, {**payload, "genmesh": GENMESH_2})
    if "combos" in payload["parts"]:
        out["combos"] = combos_rank(mesh, {**payload, "runs": COMBOS_TRAIN_2,
                                           "generate": COMBOS_GENERATE, "lra": COMBOS_LRA})
    if "tp" in payload["parts"]:
        out["tp_train"] = dp_train_rank(mesh, {**payload, "runs": TP_TRAIN_2})
        out["generate"] = tp_generate_rank(mesh, payload)
    if "pp" in payload["parts"]:
        out["pp_train"] = dp_train_rank(mesh, {**payload, "runs": PP_TRAIN_2,
                                               "save_dir": payload["pp_save_dir"],
                                               "save_shapes": ((1, 1, 1, 1, 2),)})
    return out


def four_rank(mesh, payload):
    """One rank of the 4-rank spawn: the sp part's training runs (on the sp
    4 mesh, when ``payload["sp"]``), the genmesh part's ``GENMESH_4`` (when
    ``payload["genmesh"]``), the combos part's M3 (when
    ``payload["combos"]``), then ``dp_train_rank``'s runs."""
    from orion_tpu_torch.parallel.mesh import MeshConfig

    out = {}
    if payload.get("sp"):
        out["sp_train"] = sp_train_rank(
            _remesh(mesh, MeshConfig(dp=1, sp=mesh.world), payload.get("device")),
            {"device": payload.get("device")})
    if payload.get("genmesh"):
        out["genmesh"] = genmesh_rank(mesh, {**payload, "genmesh": GENMESH_4})
    if payload.get("combos"):
        out["combos"] = combos_rank(mesh, {**payload, "runs": COMBOS_TRAIN_4})
    out["mesh"] = dp_train_rank(mesh, payload) if payload["runs"] else {}
    return out


def mesh_parts(dev, parts=("dp", "tp", "pp")):
    """The dp, tp, pp, genmesh and combos parts (``parts``; "sp": also the sp
    part's training runs), ranks of this script sharing the card over gloo,
    in at most two spawns, so each rank's start and its first step's warm-up
    are paid once: one of 2 ranks (tp's (a) and (c), pp's (a) and (c),
    ``GENMESH_2``, the combos part's M1, M2 and M4) and one of 4 (the sp
    training runs, ``GENMESH_4``, the combos part's M3, ``DP_RUNS``, tp's
    and pp's (b)), each run on its own mesh of the one
    process group. -> {part: (each kernel's launches over its runs and
    ranks, its readings)}, and for "sp" each rank's ``sp_train_rank``
    results."""
    import shutil
    import tempfile

    from orion_tpu_torch.parallel.mesh import MeshConfig

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="orion_mesh_ckpt_")
    two = None
    try:
        need = (8 if "dp" in parts else 0) + (40 if "pp" in parts else 0)
        free = shutil.disk_usage(tmp).free / 2**30
        if free < need:
            raise RuntimeError(f"the mesh parts' checkpoints (dp's fsdp 4 ~3.3 GB, pp's lm_1b3 "
                               f"~16 GB) need {need} GiB free; {free:.1f} GiB under {tmp}")
        if "tp" in parts or "pp" in parts or "genmesh" in parts or "combos" in parts:
            two = sp_spawn(2, two_rank, {"parts": parts, "pp_save_dir": os.path.join(tmp, "pp")},
                           timeout=900, mesh=MeshConfig(dp=1, tp=2) if "tp" in parts
                           else MeshConfig(dp=1, pp=2) if "pp" in parts else MeshConfig(dp=2))
        t1 = time.perf_counter()
        runs = ((DP_RUNS if "dp" in parts else ()) + (TP_TRAIN_4 if "tp" in parts else ())
                + (PP_TRAIN_4 if "pp" in parts else ()))
        four = sp_spawn(4, four_rank, {"runs": runs, "save_dir": os.path.join(tmp, "dp"),
                                       "sp": "sp" in parts, "genmesh": "genmesh" in parts,
                                       "combos": "combos" in parts},
                        timeout=1200, mesh=MeshConfig(dp=4))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t2 = time.perf_counter()
    log(f"mesh parts {parts}: the 2-rank spawn {t1 - t0:.1f} s, the 4-rank spawn "
        f"{t2 - t1:.1f} s")
    out = {"sp": [r.get("sp_train") for r in four]}
    if "genmesh" in parts:
        out["genmesh"] = genmesh_verdicts([r["genmesh"] for r in two],
                                          [r["genmesh"] for r in four])
    if "combos" in parts:
        out["combos"] = combos_verdicts([r["combos"] for r in two], [r["combos"] for r in four])
    four = [r["mesh"] for r in four]
    if "dp" in parts:
        out["dp"] = dp_verdicts(four)
    if "tp" in parts:
        out["tp"] = tp_verdicts(two, four)
    if "pp" in parts:
        out["pp"] = pp_verdicts(two, four)
    return out


# -- the fleet part: obs on a Server run, then the fleet over it ---------------------------
#
# (S) lm_1b3's host greedy Server run with the live endpoints, a declared
# latency SLO, cost attribution (on by default) and a profile of 4 chunks;
# (F1) the same requests routed over two LocalReplicas in this process;
# (F2) the fleet CLI with two process replicas, replica 0 drained mid-stream.
# The prompts are text lines of LM_PLAN's lengths, so the CLI's stdout can be
# held against F1's tokens.

FLEET_NEW = 64  # new tokens a request: 4 boundaries of 16
FLEET_SLO = ({"name": "turn_latency", "kind": "latency", "latency_ms": 5000.0, "target": 0.99},)
PROFILE_CHUNKS = 4
CONSERVATION = 1e-6  # |sum(device_ms) - sum(chunk_ms)| / sum(chunk_ms), the reference's


def fleet_lines(plan=LM_PLAN):
    """One lowercase text line a request of ``plan``, its length the plan's
    prompt length (the byte tokenizer: a token a byte)."""
    rng = np.random.default_rng(13)
    return ["".join(chr(c) for c in rng.integers(97, 123, n)) for n, _ in plan]


def _fleet_requests(lines):
    from orion_tpu_torch.generate import SampleConfig
    from orion_tpu_torch.serving import DecodeRequest
    from orion_tpu_torch.utils.tokenizer import ByteTokenizer

    tok, greedy = ByteTokenizer(), SampleConfig(temperature=0.0)
    return [DecodeRequest(np.asarray([tok.encode(ln)], np.int64), FLEET_NEW, greedy, seed=i)
            for i, ln in enumerate(lines)]


def _http_get(url, timeout=10.0):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError as e:  # refused, reset, timed out: no answer
        return 0, f"{type(e).__name__}: {e}"


def busy_share(trace_path):
    """(CUDA kernel events, the union of their and the copies' intervals over
    the trace's span, the span ms) of a torch.profiler Chrome trace."""
    events = [e for e in json.loads(Path(trace_path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    kernels = sum(e.get("cat") == "kernel" for e in events)
    if not events:
        return 0, 0.0, 0.0
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, end = 0.0, lo
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    return kernels, busy / (hi - lo) if hi > lo else 0.0, (hi - lo) / 1e3


def obs_server_check(model, lines, card, tmp):
    """(S) The plan's requests through one Server twice, by host admission:
    plain (no endpoint, no SLO, no cost), then with the live endpoints
    (``metrics_port=0``), a declared latency SLO, cost on and a profile
    directory. /profilez?chunks=4 is armed before the loop; /metrics,
    /healthz (200 while serving), /statusz, /slo and /costz are read once
    mid-run from another thread. Tokens bitwise the plain run's; the
    requests' device_ms add up to the boundaries' chunk_ms within 1e-6; the
    profile holds CUDA kernel events, and its device-busy share is logged.
    -> (plain tokens, readings)."""
    from orion_tpu_torch.serving import Server

    reqs = _fleet_requests(lines)
    gc.collect()
    srv = Server(model, _server_config("host", max_inflight=len(reqs), cost=False))
    ps = [srv.submit(r) for r in reqs]
    t0 = time.perf_counter()
    srv.serve(drain_when_idle=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain = [p.result.tokens[0].tolist() for p in ps]
    srv.close()
    del srv, ps
    gc.collect()
    srv = Server(model, _server_config("host", max_inflight=len(reqs), metrics_port=0,
                                       slo=FLEET_SLO, profile_dir=str(tmp / "prof")))
    url = f"http://127.0.0.1:{srv.http_port}"
    armed = _http_get(f"{url}/profilez?chunks={PROFILE_CHUNKS}")
    ps = [srv.submit(r) for r in reqs]
    mid = {}

    def scrape():
        deadline = time.monotonic() + 300
        while srv.stats["chunks"] < 1 and time.monotonic() < deadline:
            time.sleep(0.002)
        for route in ("/metrics", "/healthz", "/statusz", "/slo", "/costz"):
            code, body = _http_get(url + route)
            mid[route] = (code, len(body), body)
        mid["at_chunk"] = srv.stats["chunks"]

    reader = threading.Thread(target=scrape)
    reader.start()
    t0 = time.perf_counter()
    srv.serve(drain_when_idle=True)
    torch.cuda.synchronize()
    obs_s = time.perf_counter() - t0
    reader.join(timeout=300)
    got = [p.result.tokens[0].tolist() for p in ps]
    cell = srv._h_chunk_ms.cell_total()
    attributed = sum(p.result.device_ms for p in ps)
    residual = abs(attributed - cell["sum"]) / cell["sum"]
    stop = [e for e in srv.flight.events("profile") if e.get("event") == "stop"]
    t_parse = time.perf_counter()
    kernels, share, span_ms = busy_share(stop[0]["artifact"]) if stop else (0, 0.0, 0.0)
    parse_s = time.perf_counter() - t_parse
    trace_mb = Path(stop[0]["artifact"]).stat().st_size / 2**20 if stop else 0.0
    slo_doc = json.loads(mid["/slo"][2]) if "/slo" in mid else {}
    res = {"plain_s": plain_s, "obs_s": obs_s, "tokens_equal": got == plain,
           "armed": armed[0], "mid_chunk": mid.get("at_chunk"),
           "mid": {k: v[:2] for k, v in mid.items() if k.startswith("/")},
           "conservation": residual, "chunk_ms_sum": cell["sum"], "device_ms_sum": attributed,
           "prefill_tokens": [p.result.prefill_tokens for p in ps],
           "decode_tokens": [p.result.decode_tokens for p in ps],
           "profile_kernels": kernels, "profile_busy_share": share, "profile_span_ms": span_ms,
           "profile_chunks": PROFILE_CHUNKS, "profile_trace_mb": trace_mb,
           "profile_stop_ms": stop[0].get("stop_ms") if stop else None,
           "profile_export_ms": stop[0].get("export_ms") if stop else None,
           "profile_parse_s": parse_s,
           "slo_objectives": sorted((slo_doc.get("objectives") or {}))}
    log(f"lm_1b3 Server with obs ({card}): the plan's {len(reqs)} requests x {FLEET_NEW} tokens "
        f"in {obs_s:.2f} s against {plain_s:.2f} s plain; tokens bitwise the plain run's: "
        f"{res['tokens_equal']}; endpoints read at boundary {res['mid_chunk']}: {res['mid']}; "
        f"/profilez armed ({armed[0]}); device_ms {attributed:.3f} against chunk_ms "
        f"{cell['sum']:.3f} (residual {residual:.3e}, limit {CONSERVATION}); profile of "
        f"{PROFILE_CHUNKS} chunks: {kernels} CUDA kernel events, device busy "
        f"{share:.4f} of {span_ms:.1f} ms; the capture's stop {res['profile_stop_ms']} ms, "
        f"its export {res['profile_export_ms']} ms ({trace_mb:.1f} MiB), this parse "
        f"{parse_s:.2f} s")
    srv.close()
    if not (res["tokens_equal"] and armed[0] == 200 and mid.get("/healthz", (0,))[0] == 200
            and all(mid.get(r, (0,))[0] == 200 for r in ("/metrics", "/statusz", "/slo",
                                                          "/costz"))
            and "chunk_ms_bucket" in mid["/metrics"][2]
            and res["slo_objectives"] == ["turn_latency"] and residual < CONSERVATION
            and kernels > 0 and 0.0 < share <= 1.0):
        raise AssertionError(f"lm_1b3 Server with obs misbehaved: {res}")
    return plain, plain_s, res


def local_fleet_check(mods, model, reqs, card):
    """(F1) The requests routed over two LocalReplicas of the model (two
    Servers on two threads of this process, host admission), row 1's
    launches exact (24 linear layers x a solo prefill a request) under the
    two threads. -> (tokens, readings); the tokens are held against the
    Server's by ``fleet_phase``."""
    from orion_tpu_torch.fleet import LocalReplica, Supervisor

    cfg = _server_config("host", max_inflight=len(reqs))
    gc.collect()
    sup = Supervisor(lambda name: LocalReplica(model, cfg, name=name).start(), 2).start()
    try:
        _reset_counts(mods)
        t0 = time.perf_counter()
        ps = [sup.router.submit(r) for r in reqs]
        for p in ps:
            if not p.done.wait(timeout=600):
                raise AssertionError("a fleet request never resolved")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(mods)
        served = {r.name: r.server.stats["ok"] for r in sup.replicas}
    finally:
        sup.drain_all(timeout=120)
    lin, _, _, _ = _layer_counts(model.cfg)
    want = dict.fromkeys(KERNELS, 0)
    want["causal_dot_norm_wgmma"] = lin * len(reqs)
    res = {"launches": counts, "want": want, "served": served, "wall_s": wall,
           "tokens_per_s": len(reqs) * FLEET_NEW / wall,
           "statuses": [p.result.status for p in ps]}
    log(f"lm_1b3 fleet of two LocalReplicas ({card}): {len(reqs)} requests routed {served} in "
        f"{wall:.2f} s ({res['tokens_per_s']:.1f} tok/s); launches "
        f"{dict((k, v) for k, v in counts.items() if v)}, want {want['causal_dot_norm_wgmma']} "
        "of row 1")
    if counts != want or min(served.values()) < 1 or set(res["statuses"]) != {"ok"}:
        raise AssertionError(f"the in-process fleet misbehaved: {res}")
    return [p.result.tokens[0].tolist() for p in ps], res


def _children(pid):
    """(start time, pid) of the fleet's replica children of ``pid``, oldest
    first (the supervisor spawns replica 0 first)."""
    out = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
            cmd = (d / "cmdline").read_bytes().decode(errors="replace")
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[1]) == pid and "orion_tpu_torch.fleet._child" in cmd:
            out.append((int(fields[19]), int(d.name)))
    return sorted(out)


def fleet_monitor(cli_pid, err_path, out_path, timeout):
    """The F2 monitor, a process of its own (this script spawned), so that
    nothing this process does while the CLI serves (a profile's export, a
    trace's parse, both holding the interpreter lock for seconds) can delay
    the drain: tail the CLI's stderr file, stamping each line with the wall
    clock; once the telemetry line names the port, poll the aggregated
    /metrics.json until replica 0's heartbeat shows a boundary, then read
    /metrics, /healthz, /statusz and /slo and SIGTERM replica 0's child (the
    oldest child of the CLI). Runs until the CLI is gone; writes
    ``{"lines": [[t, line], ...], "mid": {...}}`` to ``out_path``."""
    lines, mid, port, pos, buf = [], {}, None, 0, ""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        alive = Path(f"/proc/{cli_pid}").exists()
        try:
            with open(err_path, encoding="utf-8", errors="replace") as f:
                f.seek(pos)
                buf += f.read()
                pos = f.tell()
        except OSError:
            pass
        *done, buf = buf.split("\n")
        now = time.time()
        for line in done:
            lines.append([now, line])
            if port is None and "fleet telemetry: http://127.0.0.1:" in line:
                port = int(line.split("http://127.0.0.1:")[1].split("/")[0])
        if not alive:
            break
        if port is not None and "sigterm_at" not in mid:
            url = f"http://127.0.0.1:{port}"
            code, body = _http_get(url + "/metrics.json")
            src = json.loads(body).get("by_source", {}) if code == 200 else {}
            chunks = sum(c["value"] for c in (src.get("replica-0.g1") or {}).get("counters", ())
                         if c["name"] == "chunks" and not c["labels"])
            kids = _children(cli_pid)
            if chunks >= 1 and kids:
                for route in ("/metrics", "/healthz", "/statusz", "/slo"):
                    c, b = _http_get(url + route)
                    mid[route] = (c, len(b))
                mid.update(children=len(kids), replica_0_chunks=chunks, sigterm_at=time.time())
                os.kill(kids[0][1], signal.SIGTERM)
        time.sleep(0.02)
    Path(out_path).write_text(json.dumps({"lines": lines, "mid": mid}))


class FleetCLI:
    """(F2) ``python -m orion_tpu_torch.fleet --config lm_1b3 --replicas 2
    --temperature 0 --metrics-port 0`` with a shared ``--session-dir`` (the
    lines as turns of sessions), the Server's knobs (4 slots, chunk 16, host
    admission) and a 0.1 s heartbeat, started in the background
    (:meth:`start`) so its children start while this process serves S and
    F1; ``fleet_monitor`` drains replica 0 mid-stream from a process of its
    own. :meth:`finish` waits for the exit and holds it: stdout bitwise the
    lines of ``tokens`` (F1's), a continuation on a replica other than 0
    with 0 < its tokens < 64, the aggregated endpoints 200 mid-run, exit 0.
    Readings: each child's time to ready, the wall time."""

    def __init__(self, lines, card, tmp, device_args=(), timeout=600):
        self.lines, self.card, self.timeout, self.tmp = lines, card, timeout, tmp
        pf = tmp / "prompts.txt"
        pf.write_text("".join(ln + "\n" for ln in lines))
        self.cmd = [sys.executable, "-m", "orion_tpu_torch.fleet", "--config", "lm_1b3",
                    "--replicas", "2", "--temperature", "0", "--metrics-port", "0",
                    "--session-dir", str(tmp / "sessions"), "--session-id", "fleet", "--slots",
                    str(SERVE_SLOTS), "--chunk", str(SERVE_CHUNK), "--prefill-chunk", "0",
                    "--prefill-buckets", "off", "--max-new-tokens", str(FLEET_NEW),
                    "--heartbeat-s", "0.1", "--prompts-file", str(pf), *device_args]

    def start(self):
        self.t0 = time.time()
        self.out_f = open(self.tmp / "cli.out", "w", encoding="utf-8")
        self.err_f = open(self.tmp / "cli.err", "w", encoding="utf-8")
        self.proc = subprocess.Popen(
            self.cmd, stdin=subprocess.DEVNULL, stdout=self.out_f, stderr=self.err_f,
            cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT), PYTHONIOENCODING="utf-8"))
        self.monitor = torch.multiprocessing.get_context("spawn").Process(
            target=fleet_monitor, args=(self.proc.pid, str(self.tmp / "cli.err"),
                                        str(self.tmp / "monitor.json"), self.timeout))
        self.monitor.start()
        return self

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        if self.monitor.is_alive():
            self.monitor.kill()

    def finish(self, tokens):
        from orion_tpu_torch.utils.tokenizer import ByteTokenizer

        try:
            self.proc.wait(timeout=self.timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.monitor.join(timeout=60)
            if self.monitor.is_alive():
                self.monitor.kill()
                self.monitor.join()
            self.out_f.close()
            self.err_f.close()
        wall = time.time() - self.t0
        mon = json.loads((self.tmp / "monitor.json").read_text())
        err = [(t - self.t0, ln) for t, ln in mon["lines"]]
        mid = dict(mon["mid"])
        if "sigterm_at" in mid:
            mid["sigterm_at_s"] = mid.pop("sigterm_at") - self.t0
        tok = ByteTokenizer()
        want = "".join(ln + tok.decode(t) + "\n" for ln, t in zip(self.lines, tokens))
        out = (self.tmp / "cli.out").read_text(encoding="utf-8")
        # the supervisor spawns one replica at a time: the first from the
        # CLI's start (its own imports included), the second after the first,
        # the respawn after the supervisor saw replica 0 exit (each stamped
        # when the monitor read it: within 20 ms)
        spawned = [(t, ln.split()[1].rstrip(":")) for t, ln in err
                   if ln.startswith("[fleet] ") and ln.endswith(": spawned")]
        exited = [t for t, ln in err if "exited; respawning" in ln]
        starts = [0.0] + [t for t, _ in spawned[:1]] + exited[:1]
        ready = {name: t - start for (t, name), start in zip(spawned, starts)}
        conts = [ln for _, ln in err if "continued after a drain" in ln]
        owed = [int(ln.split(", ")[1].split()[0]) for ln in conts]
        rc = self.proc.returncode
        res = {"rc": rc, "wall_s": wall, "stdout_equal": out == want, "ready_s": ready,
               "mid": mid, "continuations": conts, "owed": owed}
        log(f"fleet CLI (lm_1b3, 2 process replicas, {self.card}): exit {rc} in {wall:.1f} s "
            f"wall; each child's time to ready {ready} s; mid-run (aggregated) {mid}; replica 0 "
            f"SIGTERMed, continuations {conts}; stdout bitwise the in-process fleet's: "
            f"{res['stdout_equal']}")
        if not (rc == 0 and res["stdout_equal"] and conts
                and all("replica-0.g1" not in c for c in conts)
                and any(0 < n < FLEET_NEW for n in owed)
                and mid.get("/healthz", (0,))[0] == 200
                and all(mid.get(r, (0,))[0] == 200 for r in ("/metrics", "/statusz", "/slo"))):
            tail = "\n".join(ln for _, ln in err[-40:])
            raise AssertionError(f"the fleet CLI misbehaved: {res}; stderr tail:\n{tail}")
        return res


def fleet_phase(dev, mods, card, device_args=()):
    """S, F1 and F2 on lm_1b3 bf16 at full width and depth (seeded weights,
    as the CLI's children build them), in a temporary directory. F2's CLI
    starts first, so its children start while F1 and S run here; F1 then S
    in this process; F1's tokens bitwise S's plain Server run's; then F2's
    exit, its stdout held against F1's tokens. The readings of F1 and S
    overlap the children's start-up (imports, CUDA contexts); the children
    serve after S's profiled chunks."""
    import tempfile

    from orion_tpu_torch.generate import cast_params_for_inference
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM

    t0 = time.perf_counter()
    model = cast_params_for_inference(TransformerLM(
        get_config("lm_1b3"), device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    lines = fleet_lines()
    res = {}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        cli = FleetCLI(lines, card, tmp, device_args=device_args).start()
        try:
            tokens, res["local"] = local_fleet_check(mods, model, _fleet_requests(lines), card)
            t1 = time.perf_counter()
            plain, plain_s, res["obs"] = obs_server_check(model, lines, card, tmp)
            res["obs"]["phase_s"] = time.perf_counter() - t1
        except BaseException:
            cli.kill()
            raise
        res["local"]["tokens_equal"] = tokens == plain
        res["local"]["server_tokens_per_s"] = len(lines) * FLEET_NEW / plain_s
        log(f"lm_1b3 fleet of two LocalReplicas: tokens bitwise the Server's: "
            f"{res['local']['tokens_equal']}; {res['local']['tokens_per_s']:.1f} tok/s against "
            f"one Server's {res['local']['server_tokens_per_s']:.1f} ({card})")
        if not res["local"]["tokens_equal"]:
            raise AssertionError("the in-process fleet's tokens differ from the Server's")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        res["cli"] = cli.finish(tokens)
    res["phase_s"] = time.perf_counter() - t0
    log(f"fleet part: F1 {res['local']['wall_s']:.1f} s, S {res['obs']['phase_s']:.1f} s, F2's "
        f"CLI {res['cli']['wall_s']:.1f} s from F1's start; the part {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Training resilience (R2, R3; R1 rides in the adafactor_fused phase)
# ---------------------------------------------------------------------------

# lm_1b3 at full width, cut to 4 blocks (2 recomputed), as the sp / dp parts
RESILIENCE_OVER = {"n_layers": 4, "remat_skip": 2}
RESILIENCE_STEPS = 8


def train_cli(ckpt, tmp, tag, steps=RESILIENCE_STEPS, device_args=()):
    """``python -m orion_tpu_torch.train`` on lm_1b3 cut to 4 blocks, AdamW,
    B 8 x 1024 of ``data/train.bin`` (the native loader), with the
    resilience knobs, started in the background; stdout and stderr to files
    under ``tmp`` named by ``tag``."""
    over = tmp / "over.json"
    over.write_text(json.dumps({"model": RESILIENCE_OVER}))
    cmd = [sys.executable, "-m", "orion_tpu_torch.train", "--config", "lm_1b3", "--config-json",
           str(over), "--data", str(ROOT / "data" / "train.bin"), "--seq-len", "1024",
           "--batch-size", "8", "--steps", str(steps), "--ckpt-dir", str(ckpt), "--log-path",
           str(tmp / f"{tag}.jsonl"), "--metrics-path", str(tmp / f"{tag}.prom"),
           "--step-timeout", "120", "--preempt-grace", "30", "--set", "log_every=1",
           *device_args]
    out, err = (open(tmp / f"{tag}.{x}", "w", encoding="utf-8") for x in ("out", "err"))
    proc = subprocess.Popen(cmd, stdin=subprocess.DEVNULL, stdout=out, stderr=err, cwd=str(ROOT),
                            env=dict(os.environ, PYTHONPATH=str(ROOT)))
    out.close()
    err.close()
    return proc


def train_monitor(pid, log_path, out_path, at_step, timeout):
    """(R2) A process of its own (this script spawned): SIGTERM ``pid`` once
    its JSONL log at ``log_path`` shows a step >= ``at_step``; writes the
    step it saw and the time to ``out_path``. Runs until ``pid`` is gone."""
    seen, sent = 0, None
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and Path(f"/proc/{pid}").exists():
        if sent is None:
            try:
                lines = Path(log_path).read_text().splitlines()
            except OSError:
                lines = []
            steps = [json.loads(ln)["step"] for ln in lines if ln.endswith("}")]
            seen = max(steps, default=0)
            if seen >= at_step:
                os.kill(pid, signal.SIGTERM)
                sent = time.time()
        time.sleep(0.01)
    Path(out_path).write_text(json.dumps({"seen": seen, "sigterm_at": sent}))


def _finish_cli(proc, tmp, tag, timeout=600):
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, (tmp / f"{tag}.err").read_text(encoding="utf-8", errors="replace")


def _snapshot(prom):
    path = Path(str(prom) + ".json")
    if not path.exists():
        return {}, {}
    snap = json.loads(path.read_text())
    counters = {c["name"]: c["value"] for c in snap["counters"] if not c["labels"]}
    gauges = {g["labels"].get("metric"): g["value"] for g in snap["gauges"] if g["name"] == "train"}
    return counters, gauges


def _checkpoint_mismatches(a, b):
    """The leaves of two checkpoint files that are not bitwise equal."""
    from orion_tpu_torch.training.checkpoint import _leaves

    ta, tb = (torch.load(p, map_location="cpu", weights_only=True, mmap=True) for p in (a, b))
    la, lb = dict(_leaves(ta)), dict(_leaves(tb))
    if la.keys() != lb.keys():
        return sorted(la.keys() ^ lb.keys())
    return [n for n, t in la.items() if not torch.equal(t, lb[n])]


def cli_preemption(tmp, device_args=()):
    """(R2) Three runs of ``train_cli``: U uninterrupted and P, started
    together, P SIGTERMed by ``train_monitor`` once its log shows step 2;
    then P's rerun from its directory, started by a waiter thread as soon as
    P exits. Returns the running pieces for ``cli_preemption_verdict`` (this
    process serves R3 meanwhile)."""
    u = train_cli(tmp / "u_ckpt", tmp, "u", device_args=device_args)
    p = train_cli(tmp / "p_ckpt", tmp, "p", device_args=device_args)
    mon = torch.multiprocessing.get_context("spawn").Process(
        target=train_monitor, args=(p.pid, str(tmp / "p.jsonl"), str(tmp / "monitor.json"), 2,
                                    600))
    mon.start()
    run = {"u": u, "p": p, "monitor": mon, "t0": time.perf_counter()}

    def rerun_after_p():
        try:
            p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            return
        run["p_s"] = time.perf_counter() - run["t0"]
        if p.returncode == 0:
            run["rerun_t0"] = time.perf_counter()
            run["rerun"] = train_cli(tmp / "p_ckpt", tmp, "p2", device_args=device_args)

    run["waiter"] = threading.Thread(target=rerun_after_p, daemon=True)
    run["waiter"].start()
    return run


def _kill_cli(run):
    for key in ("u", "p", "rerun"):
        proc = run.get(key)
        if proc is not None and proc.poll() is None:
            proc.kill()
    run["monitor"].kill()


def cli_preemption_verdict(run, tmp, device_args=()):
    """(R2) P: exit 0, ``preempted at step N`` on stderr, only an
    off-cadence step-N checkpoint, a flight dump holding ``train_preempt``,
    its registry's ``train{metric="step"}`` N and ``train_steps_total`` N - 1
    (the steps after the first logged one, the JAX logger's count), stderr
    naming the native loader; the rerun: ``resumed from step N``, exit 0;
    its final checkpoint bitwise U's, tensor by tensor."""
    from orion_tpu_torch.training.checkpoint import step_path

    res = {}
    try:
        rc_p, err_p = _finish_cli(run["p"], tmp, "p")
        run["waiter"].join(timeout=60)
    finally:
        run["monitor"].join(timeout=60)
        if run["monitor"].is_alive():
            run["monitor"].kill()
    res["p_s"] = run.get("p_s")
    mon = json.loads((tmp / "monitor.json").read_text())
    n = int(err_p.split("preempted at step ")[1].split(":")[0]) if "preempted at step " in \
        err_p else None
    ckpt = tmp / "p_ckpt"
    files = sorted(f for f in os.listdir(ckpt) if f.endswith(".pt")) if ckpt.exists() else []
    flight_dir = ckpt / "flight"
    flights = sorted(os.listdir(flight_dir)) if flight_dir.exists() else []
    preempt_events = sum(e["kind"] == "train_preempt" for f in flights
                         for e in json.loads((flight_dir / f).read_text())["events"])
    counters, gauges = _snapshot(tmp / "p.prom")
    res.update(rc_p=rc_p, preempted_at=n, monitor=mon, files=files, flights=flights,
               train_steps_total=counters.get("train_steps_total"), step_gauge=gauges.get("step"),
               native="through NativeTokenBinDataset" in err_p)
    rc_2, err_2 = (_finish_cli(run["rerun"], tmp, "p2") if "rerun" in run
                   else (None, "no rerun: P failed"))
    res["rerun_s"] = time.perf_counter() - run.get("rerun_t0", time.perf_counter())
    rc_u, err_u = _finish_cli(run["u"], tmp, "u")
    res.update(rc_2=rc_2, rc_u=rc_u, resumed=f"resumed from step {n}" in err_2)
    final = RESILIENCE_STEPS
    res["mismatched"] = (_checkpoint_mismatches(step_path(str(ckpt), final),
                                                step_path(str(tmp / "u_ckpt"), final))
                         if rc_2 == 0 and rc_u == 0 else ["no final checkpoint"])
    res["wall_s"] = time.perf_counter() - run["t0"]
    log(f"R2 train CLI (lm_1b3 4 blocks, AdamW, B8 x 1024 of data/train.bin): SIGTERM after "
        f"step {mon['seen']} -> exit {rc_p}, preempted at step {n}, checkpoints {files}, flight "
        f"dumps {flights} ({preempt_events} train_preempt events), registry step {gauges.get('step')} "
        f"train_steps_total {counters.get('train_steps_total')}, native loader named: "
        f"{res['native']}; P exited at {res['p_s']} s, its rerun exit {rc_2} (resumed from step "
        f"{n}: {res['resumed']}) {res['rerun_s']:.1f} s after; uninterrupted exit {rc_u}; final "
        f"checkpoints bitwise: "
        f"{not res['mismatched']} ({res['mismatched'][:5]}); the part {res['wall_s']:.1f} s")
    ok = (rc_p == 0 and n is not None and 2 <= n < final and files == [f"step-{n:08d}.pt"]
          and preempt_events >= 1 and res["step_gauge"] == n
          and res["train_steps_total"] == n - 1 and res["native"] and rc_2 == 0
          and res["resumed"] and rc_u == 0 and not res["mismatched"])
    if not ok:
        raise AssertionError(f"R2: the train CLI's preemption misbehaved: {res}\nP stderr tail:\n"
                             f"{err_p[-3000:]}\nrerun stderr tail:\n{err_2[-2000:]}\nU stderr "
                             f"tail:\n{err_u[-2000:]}")
    return res


def inprocess_faults(dev, mods, tmp):
    """(R3) lm_1b3 cut to 4 blocks, AdamW, B 8 x 1024, in this process:
    ``poison_nan_at(2)``: the params after step 2 bitwise those after step
    1, ``nonfinite`` 1, step 3's loss finite; ``fail_io("ckpt.save", 2,
    times=2)``: step 2's save lands after two retries and verifies;
    ``corrupt_step`` on it (the newest): the default restore falls back to
    step 1 with a warning, a pinned restore of step 2 raises;
    ``fail_io("data.batch", 1, times=2)`` on ``data/train.bin`` through the
    native loader: batch 1 bitwise the twin's. Launches exact over the 3
    steps (counts set to 0 just before the first)."""
    import warnings

    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.resilience.retry import RetryPolicy
    from orion_tpu_torch.training.checkpoint import Checkpointer
    from orion_tpu_torch.training.data import (
        DataLoader, SyntheticDataset, TokenBinDataset, make_dataset)
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    cfg = TrainConfig(model=get_config("lm_1b3", **RESILIENCE_OVER), steps=3, batch_size=8,
                      seq_len=1024)
    trainer = Trainer(cfg, device=dev)
    ds = SyntheticDataset(cfg.model.vocab_size, cfg.seq_len)
    batches = [torch.from_numpy(ds.batch(0, i, 8)).long().to(dev) for i in range(3)]
    ck = Checkpointer(str(tmp / "r3_ckpt"), save_every=0,
                      retry=RetryPolicy(attempts=4, base_delay=0.05, max_delay=0.2))
    res = {}
    _reset_counts(mods)
    trainer.step(batches[0])
    after_1 = {n: p.detach().clone() for n, p in trainer.params.items()}
    plan = inject.FaultPlan().poison_nan_at(2).fail_io("ckpt.save", 2, times=2)
    with inject.inject(plan), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ck.maybe_save(1, trainer.state_dict(), force=True)
        m2 = trainer.step(batches[1])
        saved = ck.maybe_save(2, trainer.state_dict(), force=True)
    retried = sum("retrying" in str(x.message) for x in w)
    same = [n for n, p in trainer.params.items() if not torch.equal(p, after_1[n])]
    restored = ck.restore(step=2)
    verify = all(torch.equal(restored["params"][n].to(dev), p) for n, p in trainer.params.items())
    del restored, after_1
    m3 = trainer.step(batches[2])
    counts = _counts(mods)
    lin, _, lin_remat, _ = _layer_counts(cfg.model)
    want = dict.fromkeys(KERNELS, 0)
    want.update(causal_dot_norm_wgmma=3 * (lin + lin_remat), causal_dot_dq_den_wgmma=3 * lin,
                causal_dot_rev_den_wgmma=3 * lin)
    res.update(delivered=list(plan.delivered), nonfinite=int(m2["nonfinite_total"]),
               poisoned_loss=m2["loss"], loss_3=m3["loss"], params_moved=same[:5], saved=saved,
               retried=retried, verified=verify, launches=counts)
    from orion_tpu_torch.resilience.inject import corrupt_step

    corrupt_step(ck.directory, 2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fallback = int(ck.restore()["step"])
    warned = any("corrupt or incomplete" in str(x.message) for x in w)
    try:
        ck.restore(step=2)
        pinned = "did not raise"
    except Exception as e:  # a pinned step never falls back
        pinned = type(e).__name__
    res.update(fallback_step=fallback, fallback_warned=warned, pinned=pinned)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    data = make_dataset(str(ROOT / "data" / "train.bin"), 1024)
    plan = inject.FaultPlan().fail_io("data.batch", 1, times=2)
    with inject.inject(plan), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loader = DataLoader(data, 8, seed=0, device=dev)
        try:
            b0, b1 = next(loader), next(loader)
        finally:
            loader.close()
    twin = TokenBinDataset(str(ROOT / "data" / "train.bin"), 1024)
    res.update(data_delivered=list(plan.delivered), loader=type(data).__name__,
               batch_bitwise=bool(np.array_equal(b1.cpu().numpy(), twin.batch(0, 1, 8))
                                  and np.array_equal(b0.cpu().numpy(), twin.batch(0, 0, 8))))
    res["s"] = time.perf_counter() - t0
    log(f"R3 in-process (lm_1b3 4 blocks, AdamW, B8 x 1024): poisoned step 2: loss "
        f"{res['poisoned_loss']}, nonfinite {res['nonfinite']}, params moved {same[:5]} (want "
        f"none), step 3 loss {res['loss_3']:.4f}; step 2's save with 2 injected faults landed: "
        f"{saved} after {retried} retries, verified {verify}; step 2 corrupted: the restore fell "
        f"back to step {fallback} (warned: {warned}), the pinned restore raised {pinned}; "
        f"data.batch failing twice at step 1 through {res['loader']}: batches bitwise the twin's "
        f"{res['batch_bitwise']} ({plan.delivered}); launches {counts} (want {want}); "
        f"{res['s']:.1f} s")
    ok = (res["delivered"] == ["train.nan@2", "ckpt.save@2", "ckpt.save@2"]
          and res["nonfinite"] == 1 and not np.isfinite(res["poisoned_loss"]) and not same
          and np.isfinite(res["loss_3"]) and saved and retried == 2 and verify
          and fallback == 1 and warned and pinned != "did not raise"
          and res["data_delivered"] == ["data.batch@1"] * 2
          and res["loader"] == "NativeTokenBinDataset" and res["batch_bitwise"])
    if not ok or counts != want:
        raise AssertionError(f"R3 misbehaved: {res} (launches want {want})")
    return res


def train_part(dev, mods, device_args=()):
    """R2 and R3: the train CLI's preemption runs in the background (its
    own processes on this card) while this process runs R3."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        tmp = Path(d)
        run = cli_preemption(tmp, device_args=device_args)
        try:
            r3 = inprocess_faults(dev, mods, tmp)
            r2 = cli_preemption_verdict(run, tmp, device_args=device_args)
        except BaseException:
            _kill_cli(run)
            raise
    res = {"r2": r2, "r3": r3, "s": time.perf_counter() - t0}
    log(f"training resilience part: R2 {r2['wall_s']:.1f} s (P and U together, P's rerun when P "
        f"exited), "
        f"R3 {r3['s']:.1f} s inside it; the part {res['s']:.1f} s")
    return res


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


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser("chip_smoke.py")
    ap.add_argument("--part", choices=("all", "fleet", "train", "tp", "pp", "genmesh", "combos"),
                    default="all",
                    help="fleet / train / tp / pp / genmesh / combos: the build, the kernel checks "
                    "and the fleet part, the training-resilience part (R1 in lm_1b3's "
                    "adafactor_fused phase, R2, R3), the tensor-parallel part, the pipeline part, "
                    "generate on meshes or the mesh combinations (MoE under sp, dropout on "
                    "meshes, LRA on a mesh), alone")
    args = ap.parse_args(argv)
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
    torch.cuda.empty_cache()
    if args.part == "fleet":
        fleet = fleet_phase(dev, mods, card)
        log(f"fleet phases done at {time.perf_counter() - t0:.1f} s")
        for k in kernels:  # the main path of this part: the in-process fleet
            k["launches"] = k["launches_fleet"] = fleet["local"]["launches"][k["name"]]
        return _finish(card, kernels)
    if args.part == "train":
        af_train, train = resilience_phases(dev, mods, t0)
        for k in kernels:  # the main path of this part: R1's two runs and R3's steps
            k["launches"] = af_train["then"]["launches"][k["name"]] + \
                train["r3"]["launches"][k["name"]]
            _resilience_launches(k, af_train, train)
        return _finish(card, kernels)
    if args.part == "tp":
        # the sp pieces' entries (the parts of rows 1, 3, 4 that sp x tp runs,
        # rows 6-8 with shift / q_offset), each held against its plain version
        kernels += check_sp_kernels(causal_dot, flash_attention, dev)
        torch.cuda.empty_cache()
        tp_launches, tp_memory = tp_phase(dev)
        log(f"tp phases done at {time.perf_counter() - t0:.1f} s; peak memory, resident bytes "
            f"and transport a rank: {tp_memory}")
        for k in kernels:  # the main path of this part: its runs' launches over the ranks
            k["launches"] = k["launches_tp"] = tp_launches.get(k["name"], 0)
        return _finish(card, kernels)
    if args.part == "genmesh":
        gm_launches, gm_readings = genmesh_phase(dev)
        log(f"genmesh phases done at {time.perf_counter() - t0:.1f} s; readings a rank: "
            f"{gm_readings}")
        for k in kernels:  # the main path of this part: its runs' launches over the ranks
            k["launches"] = k["launches_genmesh"] = gm_launches.get(k["name"], 0)
        return _finish(card, kernels)
    if args.part == "combos":
        # the sp pieces' entries (the parts of rows 1, 3, 4 that M1's and M3's
        # sp runs launch), each held against its plain version
        kernels += check_sp_kernels(causal_dot, flash_attention, dev)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        co_launches, co_readings = combos_phase(dev)
        log(f"combos phases done at {time.perf_counter() - t0:.1f} s ({time.perf_counter() - t1:.1f}"
            f" s); readings a rank: {co_readings}")
        for k in kernels:  # the main path of this part: its runs' launches over the ranks
            k["launches"] = k["launches_combos"] = co_launches.get(k["name"], 0)
        return _finish(card, kernels)
    if args.part == "pp":
        # the sp pieces' entries (the parts of rows 1, 3, 4 that pp x sp runs
        # inside its stages), each held against its plain version
        kernels += check_sp_kernels(causal_dot, flash_attention, dev)
        torch.cuda.empty_cache()
        pp_launches, pp_memory = pp_phase(dev)
        log(f"pp phases done at {time.perf_counter() - t0:.1f} s; peak memory, resident bytes, "
            f"transport and n_micro a rank: {pp_memory}")
        for k in kernels:  # the main path of this part: its runs' launches over the ranks
            k["launches"] = k["launches_pp"] = pp_launches.get(k["name"], 0)
        return _finish(card, kernels)
    # sequence parallelism: ranks as processes sharing this card
    sp_lines = sp_phase(causal_dot, flash_attention, dev, train=False)
    # sp training, data, tensor and pipeline parallelism: ranks as processes
    # sharing this card, one spawn of 2 and one of 4 for the four parts
    dropout_cost(dev)
    parts = mesh_parts(dev, ("sp", "dp", "tp", "pp", "genmesh", "combos"))
    sp_lines, sp_memory = sp_train_verdicts(sp_lines, parts["sp"])
    log(f"sp phases done at {time.perf_counter() - t0:.1f} s; transport and peak memory a rank: "
        f"{sp_memory}")
    (dp_launches, dp_memory), (tp_launches, tp_memory), (pp_launches, pp_memory) = (
        parts["dp"], parts["tp"], parts["pp"])
    gm_launches, gm_readings = parts["genmesh"]
    co_launches, co_readings = parts["combos"]
    log(f"dp, tp, pp, genmesh and combos phases done at {time.perf_counter() - t0:.1f} s; peak "
        f"memory, resident bytes, transport (and n_micro) a rank: dp {dp_memory}, tp "
        f"{tp_memory}, pp {pp_memory}; genmesh readings a rank: {gm_readings}; combos "
        f"readings: {co_readings}")
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
    af_train, train = resilience_phases(dev, mods, t0)
    loaded = af_train["then"]["load"]
    tiny_train(dev, TINY, "tiny adafactor_fused", optimizer="adafactor_fused")
    log(f"lm_1b3 adafactor_fused step {af_train['step_ms']:.2f} ms against AdamW's "
        f"{lm_train['step_ms']:.2f} in this run")
    log(f"quantized serving, Adafactor and training resilience phases done at "
        f"{time.perf_counter() - t0:.1f} s")

    # the options at lm_1b3's width, cut to 4 blocks (2 recomputed): the
    # feature maps of rows 1, 3 and 4 (every launch wgmma), remat "dots",
    # bfloat16_sr storage, each beside the same cut of the elu+1 AdamW run
    t_opt = time.perf_counter()
    cut = RESILIENCE_OVER
    base4 = train_phase(dev, mods, "lm_1b3", 1024, cut)
    favor = {**cut, "feature_map": "favor"}
    learnable = {**cut, "feature_map": "learnable", "tie_embeddings": False}
    fm_runs = {}
    for label, over in (("favor", favor), ("learnable_untied", learnable)):
        spread_missed, spread = plain_spread(dev, "lm_1b3", 1024, over)
        fm_gen = generate_phase(dev, mods, "lm_1b3", 1024, 32, over, audit=True,
                                model_limits=not spread_missed)
        fm_train = train_phase(dev, mods, "lm_1b3", 1024, over)
        fm_grad = grad_check(dev, "lm_1b3", 1024, overrides=over, audit=True,
                             model_limits=not spread_missed)
        fm_runs[label] = {"generate": fm_gen["launches"], "train": fm_train["launches"]}
        log(f"lm_1b3 (4 blocks) {label}: kernels vs plain, prefill logits "
            f"{fm_gen['logits_max_abs_err']:.4e}, gradients up to "
            f"{fm_grad['grad_rel_l2_max']:.4g} relative L2; the plain path against itself "
            f"{spread['logits_max_abs']:.4e}, {spread['grad_rel_l2_max']:.4g}; train step "
            f"{fm_train['step_ms']:.2f} ms against elu+1's {base4['step_ms']:.2f}")
    # the int8 untied head (lm_head_kernel_q) at lm_1b3's width
    quant_generate_phase(dev, mods, "lm_1b3", 1024, 32, "int8", learnable)
    dots = train_phase(dev, mods, "lm_1b3", 1024, {**cut, "remat_policy": "dots"})
    log(f"lm_1b3 (4 blocks) remat 'dots' step {dots['step_ms']:.2f} ms, max memory allocated "
        f"{dots['max_memory_gib']:.2f} GiB against 'full''s {base4['step_ms']:.2f} ms, "
        f"{base4['max_memory_gib']:.2f} GiB in this run; first losses {dots['losses'][0]!r} "
        f"vs {base4['losses'][0]!r}")
    if dots["losses"][0] != base4["losses"][0]:
        raise AssertionError("remat 'dots' changed the first step's loss")
    grad_check(dev, "lm_1b3", 1024, overrides={**cut, "remat_policy": "dots"},
               ref_overrides={"remat_policy": "full"})
    sr_ms = sr_check(dev)
    sr = train_phase(dev, mods, "lm_1b3", 1024, cut, steps=5, param_storage="bfloat16_sr",
                     then=_storage)
    log(f"lm_1b3 (4 blocks) bfloat16_sr storage ({sr['then']} params): step "
        f"{sr['step_ms']:.2f} ms, max memory allocated {sr['max_memory_gib']:.2f} GiB against "
        f"fp32 storage's {base4['step_ms']:.2f} ms, {base4['max_memory_gib']:.2f} GiB in this run")
    log(f"feature map, remat and storage phases done at {time.perf_counter() - t0:.1f} s "
        f"({time.perf_counter() - t_opt:.1f} s)")

    lra = {}
    for name, t, b in (("lra_listops_linear", 2000, 32), ("lra_listops_softmax", 2000, 32),
                       ("lra_text_linear", 4000, 16), ("lra_text_softmax", 4000, 16)):
        lra[name] = lra_phase(dev, mods, name, t, b)
        lra[name]["card_vs_cpu"] = lra_card_vs_cpu(dev, name, t)
    log(f"LRA phases done at {time.perf_counter() - t0:.1f} s")

    row_forms(dev)
    both = (("greedy", "host"), ("greedy", "inscan"), ("sampled", "host"), ("sampled", "inscan"))
    host = (("greedy", "host"), ("sampled", "host"))
    t_serve = time.perf_counter()
    # at 4 blocks (the hybrid's keep both layer kinds: swa, swa, swa, linear):
    # every serving check, lm_1b3's (b), (f), (g), times, ladder, sessions,
    # Server phase, stores part and speculative part, the int4 (f), host
    # Server runs, stores part and speculative part, the hybrid's (b), (f),
    # (g), times, ladder, session, host Server runs, stores part and
    # speculative part (the whole run's time pays for the sp, dp, tp and pp
    # parts); the CLIs serve the full depth; "f" gives the plain runs
    # speculation is held against
    from orion_tpu_torch.models.configs import hybrid_pattern

    serving = {
        "lm_1b3": serving_phase(dev, mods, "lm_1b3", LM_PLAN, card,
                                checks=("b", "f", "g", "times", "ladder", "session",
                                        "decode_session", "server_full", "stores", "stores_full",
                                        "spec", "spec_full", "spec_mutant"),
                                server_runs=both, overrides=RESILIENCE_OVER),
        "lm_1b3_int4": serving_phase(dev, mods, "lm_1b3", LM_PLAN, card, quant="int4",
                                     checks=("f", "stores", "spec"), server_runs=host,
                                     overrides=RESILIENCE_OVER),
        # the hybrid's in-scan pieces run its swa plain, as in JAX: row 6 only
        # in the host (solo) prefill and a prefix publish's
        "hybrid_1b3": serving_phase(dev, mods, "hybrid_1b3", HYBRID_PLAN, card,
                                    checks=("b", "f", "g", "times", "ladder", "session", "stores",
                                            "spec", "spec_full"), server_runs=host,
                                    overrides={**RESILIENCE_OVER,
                                               "layer_types": hybrid_pattern(4)}),
    }
    log(f"serving phases done at {time.perf_counter() - t0:.1f} s "
        f"({time.perf_counter() - t_serve:.1f} s)")
    fleet = fleet_phase(dev, mods, card)
    log(f"fleet phases done at {time.perf_counter() - t0:.1f} s")

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
        _resilience_launches(k, af_train, train)
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
            # the Server's stores: a prefix miss and its publish, the hits, the
            # session turns, the outage's three turns
            k["launches_stores"] = {label: {run: c[k["name"]]
                                            for run, c in r["stores"]["launches"].items()}
                                    for label, r in serving.items()}
            # the speculative part: the plan again with spec_depth 4 (rows 1
            # and 6 only in admissions; row 14 in the draft steps and the
            # verify pieces), and through a speculating Server
            k["launches_spec"] = {label: {run: c[k["name"]]
                                          for run, c in r["spec"]["launches"].items()}
                                  for label, r in serving.items()}
    for k in kernels:  # the requests routed over two LocalReplicas (row 1: 24 x 6)
        k["launches_fleet"] = fleet["local"]["launches"][k["name"]]
    kernels += sp_lines  # launches: the sp training runs' totals over the ranks
    for k in kernels:  # each kernel's launches over the dp, tp and pp parts' steps and ranks
        k["launches_dp"] = dp_launches.get(k["name"], 0)
        k["launches_tp"] = tp_launches.get(k["name"], 0)
        k["launches_pp"] = pp_launches.get(k["name"], 0)
        k["launches_genmesh"] = gm_launches.get(k["name"], 0)
        k["launches_combos"] = co_launches.get(k["name"], 0)
    return _finish(card, kernels)


def resilience_phases(dev, mods, t0):
    """lm_1b3's adafactor_fused phase with R1 and the load phase, then R2
    and R3; each part's seconds logged."""
    t1 = time.perf_counter()
    af_train = train_phase(dev, mods, "lm_1b3", 1024, optimizer="adafactor_fused",
                           then=lambda trainer: adafactor_resilience(dev, mods, trainer))
    log(f"adafactor_fused phase with R1 and the load phase done at {time.perf_counter() - t0:.1f} s "
        f"({time.perf_counter() - t1:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    train = train_part(dev, mods)
    log(f"training resilience part (R2, R3) done at {time.perf_counter() - t0:.1f} s "
        f"({train['s']:.1f} s)")
    return af_train, train


def _resilience_launches(k, af_train, train):
    """Rows 1, 3, 4 and 11-13 in R1's two runs (lm_1b3 adafactor_fused, 4
    steps) and R3's 3 steps (4 blocks, AdamW)."""
    if k["name"] in ("causal_dot_norm_wgmma", "causal_dot_dq_den_wgmma",
                     "causal_dot_rev_den_wgmma") or k["name"].startswith("adafactor"):
        k["launches_train_resilience"] = {"r1": af_train["then"]["launches"][k["name"]],
                                          "r3": train["r3"]["launches"][k["name"]]}


def _finish(card, kernels) -> int:
    """The card line, the kernels line, the result line last."""
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
