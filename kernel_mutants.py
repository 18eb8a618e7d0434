"""Which wrong kernels ``chip_smoke.py``'s agreement limits reject.

    python3 kernel_mutants.py

On a machine with one CUDA card and ``nvcc``. Builds the sound kernels and
deliberately wrong copies of them, each made by one textual edit of a
source in ``orion_tpu_torch/csrc/``: ``causal_dot_norm.cu`` ("fwd", the
linear forward and the public op's raw forward), ``causal_dot_bwd.cu``
("bwd", the backward kernels of both),
``flash_attention.cu`` ("flash_fwd": the wgmma kernel's copies named
``flash_wgmma_fwd_*``, the simt kernel's the other ``flash_*``),
``flash_attention_bwd.cu`` ("flash_bwd", dq and dk/dv: the wgmma kernels'
copies named ``flash_wgmma_*``, faults of their data, masks, loops and
pipeline, the simt kernels' the other ``flash_*``), ``gmm.cu`` ("gmm", the grouped matmul's
forward and dw: the wgmma kernels' copies named ``gmm_wgmma_*``, faults of
their data and of their TMA / mbarrier / wgmma pipeline, the simt kernels'
the other ``gmm_*``), ``q4_matmul.cu`` ("q4", the int4 dequant-matmul: the
mma kernel's copies named ``q4_mma_*``, the simt kernel's the other ``q4_*``) or
``adafactor.cu`` ("adafactor", the fused Adafactor's three passes); in
``causal_dot_norm.cu`` the wgmma kernel's copies are named ``norm_wgmma_*``,
in ``causal_dot_bwd.cu`` the wgmma kernels' ``bwd_wgmma_*``, and the copies
of the public op's two kernels ``raw_*`` (``raw_wgmma_*`` for the raw
forward's wgmma kernel, the walk it shares with row 1, and
``raw_wgmma_rev_*`` for the raw reverse pass's, the walk it shares with
rows 3 and 4: each changed for the raw instance only).
A copy whose text lies in the shared header ``hopper.cuh`` instead of the
source patches the header: the source and the patched header go together
into a directory of their own, where the source's ``#include "hopper.cuh"``
finds the copy first. All copies are written under
``orion_tpu_torch/_build/mutants/`` (the sources in the checkout are never
changed); all the builds start together, one nvcc each. Then it holds each
copy against the plain versions with ``chip_smoke.compare_causal_dot``
(linear forward copies, at the generate path's shape),
``chip_smoke.compare_raw`` (the copies named ``raw_*``, of the public op's
two kernels, on all its cases),
``chip_smoke.compare_training_kernels`` (linear backward copies, at the
training shape), ``chip_smoke.compare_flash`` and
``chip_smoke.compare_flash_sp`` (flash copies, on all their cases: the
second holds the sequence-parallel rings' blocks, with shift, q_offset and
rows that see no key; the sound kernels and the copies in ``SP_MUTANTS``
also run through ``chip_smoke.sp_bodies_rank`` at sp 4, four ranks sharing
the card, whose readings are printed), ``chip_smoke.compare_gmm`` (gmm copies, on all its cases),
``chip_smoke.compare_q4`` or ``chip_smoke.compare_adafactor`` (on all their
cases; Adafactor copies also through ``chip_smoke.compare_adafactor_update``,
one update against the plain formulas), prints, per kernel, its readings and whether ``chip_smoke.agrees`` /
``agrees_training`` / ``agrees_raw`` / ``agrees_flash`` / ``agrees_gmm`` / ``agrees_q4`` /
``agrees_adafactor`` accepts it, then all of it as one JSON line. Exits nonzero if a sound kernel is rejected or a kernel that
must be rejected is not. Imports nothing of JAX.

    python3 kernel_mutants.py --genmesh

instead runs ``chip_smoke.py``'s G4 int4 run (lm_1b3 at 4 blocks, dp 2 x tp
2, four ranks sharing the card) twice: as it is, and with each rank
quantizing its own tp shard (a row-parallel scale then the max over the
rank's slice of the input, not the whole input: ``GENMESH_MUTANT``), and
exits nonzero unless ``chip_smoke.genmesh_verdict`` accepts the first and
rejects the second.

    python3 kernel_mutants.py --combos

instead runs ``chip_smoke.py``'s combos part's training runs twice, four
ranks sharing the card for M3 (lm_1b3 at 4 blocks with dropout, dp 2 x tp 2
and sp 2 x dp 2) and two for M1 (the dropless MoE trained at sp 2): as they
are, and with a wrong copy of the port (``COMBOS_MUTANTS``): M3's masks
drawn at each rank's shape (its rows and tokens counted from 0, the port's
behaviour before its masks were keyed by position), M1's load-balance
statistics taken over each rank's own tokens (no mean over the data x sp
ranks). Exits nonzero unless ``chip_smoke.combos_train_verdict`` accepts
every sound run and rejects every mutant run that must be rejected: M3's.
M1's is printed and may pass: at ``moe_aux_weight`` 1e-2 it moves only the
router's gradient, by about 3e-2 relative L2 at full width, inside the
gradient limit (5e-2); the CPU tests (``tests/test_torch_sp_moe.py``, at the
JAX Trainer's 3e-5) are its guard.

    python3 kernel_mutants.py --sass-against DIR

instead builds every source of this checkout and of the checkout ``DIR``
with the library's nvcc command, disassembles both (``cuobjdump -sass``),
matches the kernels by name and template arguments (``cu++filt``, the
parameter types left out) and prints, per source, which kernels
compile to identical SASS, which differ and which are in one checkout only,
then all of it as one JSON line. Needs the CUDA toolkit, no card.
"""

import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke
from orion_tpu_torch.ops.kernels import adafactor, causal_dot, flash_attention, gmm, library
from orion_tpu_torch.ops.kernels import q4_matmul

# source name -> (wrapper module, its SOURCES key)
SOURCES = {"fwd": (causal_dot, "fwd"), "bwd": (causal_dot, "bwd"),
           "flash_fwd": (flash_attention, "fwd"), "flash_bwd": (flash_attention, "bwd"),
           "gmm": (gmm, "gmm"), "q4": (q4_matmul, "q4"), "adafactor": (adafactor, "adafactor")}
_DW_ROWS = "const int n_rows = tile_count[e] * tile_rows;"
_DW_STEPS = "const int n_k = tile_count[e] * (tile_rows / WK);"
_WAIT_STEP = "    wgmma_wait<1>();  // the step before is done: release its stage"
_FWD_CONSUME = "consume<0, 1, KMAJOR_LBO, KMAJOR_STEP, MNMAJOR_LBO, MNMAJOR_STEP>(r, n_k, acc);"
_DW_CONSUME = "consume<1, 1, MNMAJOR_LBO, MNMAJOR_STEP, MNMAJOR_LBO, MNMAJOR_STEP>(r, n_k, acc);"
_AF_FINAL = ("    sums[n + i] = t;\n  } else if (i < m + n) {\n    const int j = i - m;\n"
             "    float t = 0.f;\n    for (int rc = 0; rc < n_rc; ++rc) t += colpart[(size_t)rc * n + j];\n"
             "    sums[j] = t;")
_DQ_DS = ("split_pair(p0 * (dp[j] - dl[h]) * scale, p1 * (dp[j + 1] - dl[h]) * scale, "
          "dhi[j / 2],")
_DKV_DS = ("split_pair(p0 * (dp[j] - dl.x) * scale, p1 * (dp[j + 1] - dl.y) * scale, "
           "dhi[j / 2],")
_DV_HI = "wgmma_m64n128k16<1>(acc_dv, phi + 4 * kk, mnmajor(gs, kk));"
# the reverse wgmma walk's text; sizeof(TO) == 4 singles out row 5's instance
# (fp32 outputs), so rows 3 and 4 stay sound in those copies
_REV_KEEP = ("const bool keep0 = REV ? col >= t : col <= t;\n"
             "      const bool keep1 = REV ? col + 1 >= t : col + 1 <= t;")
_DK_SEED = ("      sa[j] = p.st0[s_base + (size_t)n * WDX + m];\n"
            "      sb[j] = p.st0[s_base + (size_t)n * WDX + m + 64];")
_BWD_ST_LO = ("for (int kk = 0; kk < WDX / 16; ++kk)\n      wgmma_m64n64k16<0, 1>(o, kmajor(xs, kk), "
              "mnmajor(r.st_lo(), kk));")
HEADER = "hopper.cuh"  # the header the wgmma sources share, in library.CSRC
# the sp rings' mutants, also run through chip_smoke's sp bodies (their
# limits are reported; the kernel-piece limits are the ones that must reject)
SP_MUTANTS = ("flash_wgmma_fwd_q_offset_dropped", "flash_wgmma_shift_dropped",
              "flash_wgmma_dkv_lo_unmoved", "flash_wgmma_fwd_empty_lse_inf")


def _moved_ahead(path, block_start, block_end, ahead_of, between):
    """(old, new) for a copy of ``path`` in which the block from the line
    ``block_start`` through ``block_end`` runs before the line ``ahead_of``,
    followed by ``between``: the text from ``ahead_of`` to the block's end,
    and the same with the block first."""
    text = Path(path).read_text()
    a = text.index(ahead_of)
    b = text.index(block_start, a)
    c = text.index(block_end, b) + len(block_end)
    return text[a:c], text[b:c] + between + text[a:b]


# the linear-attention wgmma forward with its state update (S += k^T v and
# the halves written to shared memory) ahead of the chunk's num = A v + q S
_STATE_FIRST = _moved_ahead(
    causal_dot.SOURCES["fwd"], "    // S += k^T v: k^T read MN-major",
    "    write_state(sa, sb, s_hi, s_lo);\n    fence_async_smem();\n",
    "    // num = A v + q S: A's halves", "    named_barrier(1, 128);\n")
_Z_SUM = ("acc += __bfloat162float(*reinterpret_cast<const bf16*>(kt + tile_offset(t, tid)));\n"
          "      zs[tid] += acc;")
_Q4_UNPACK = ("const float lo = (float)((int)(w << (28 - 8 * c)) >> 28);\n"
              "            const float hi = (float)((int)(w << (24 - 8 * c)) >> 28);")

# (name, source, what it breaks, text of the source, its replacement, must be rejected)
MUTANTS = [
    ("no_diagonal", "fwd",
     "masks the scores to s < t: each token's own k_t v_t leaves num and den",
     "as[t * LDA + s] = (s <= t) ? acc[i][j] : 0.f;",
     "as[t * LDA + s] = (s < t) ? acc[i][j] : 0.f;", True),
    ("state_skips_last_row", "fwd", "leaves each chunk's last token out of the carried S",
     "for (int s = 0; s < rows; ++s) {\n        float a[8], b[4];",
     "for (int s = 0; s < rows - 1; ++s) {\n        float a[8], b[4];", True),
    ("z0_ignored", "fwd", "starts z from zero instead of z0",
     "zs[d] = (z0 != nullptr && d < dk) ? z0[(size_t)bh * dk + d] : 0.f;",
     "zs[d] = 0.f;", True),
    ("bf16_scores", "fwd", "rounds the masked scores to bf16 (the TPU kernel keeps them fp32)",
     "as[t * LDA + s] = (s <= t) ? acc[i][j] : 0.f;",
     "as[t * LDA + s] = (s <= t) ? __bfloat162float(__float2bfloat16_rn(acc[i][j])) : 0.f;",
     True),
    ("den_of_row_0", "fwd", "writes every row's den from the chunk's first row",
     "den_out[(size_t)bh * t_len + c0 + tid] = dens[tid];",
     "den_out[(size_t)bh * t_len + c0 + tid] = dens[0];", True),
    ("rev_strict_anti", "bwd",
     "masks the reverse pass's scores to s > t: dk and dv lose each token's own term",
     "const bool keep = REV ? (s >= t) : (s <= t);",
     "const bool keep = REV ? (s > t) : (s <= t);", True),
    ("dq_strict_causal", "bwd", "masks the dq pass's scores to s < t",
     "const bool keep = REV ? (s >= t) : (s <= t);",
     "const bool keep = REV ? (s >= t) : (s < t);", True),
    ("gzf_dropped", "bwd",
     "drops the gzf broadcast: dk and dz0 start the suffix sum from zero",
     "make_walk<T, T>(v, g, q, gden, gsf, 1, gzf, dk_out, nullptr, dz0, dv, dk);",
     "make_walk<T, T>(v, g, q, gden, gsf, 1, nullptr, dk_out, nullptr, dz0, dv, dk);", True),
    ("dsf_not_seeded", "bwd", "does not seed R with dSf^T in the reverse pass",
     "if (p.st0 != nullptr && d < p.dx && j < dwt) {",
     "if (ROLE == ROLE_DQ && p.st0 != nullptr && d < p.dx && j < dwt) {", True),
    ("dq_gden_dropped", "bwd",
     "drops the in-chunk denominator term gden_t sum_{s<=t} k_s from dq",
     "if (DEN && ROLE == ROLE_DQ) v += gds[t];", "", True),
    ("dk_gden_dropped", "bwd",
     "drops the in-chunk denominator term sum_{s>=t} gden_s q_s from dk",
     "if (DEN && ROLE == ROLE_DK) v += gds[s];", "", True),
    ("dq_z0_ignored", "bwd", "starts dq's prefix z from zero instead of z0",
     "zs[j] = (p.z0 != nullptr && j < dwt)",
     "zs[j] = (ROLE == ROLE_DK && p.z0 != nullptr && j < dwt)", True),
    ("raw_no_diagonal", "fwd",
     "masks the raw kernel's scores to s < t: each token's own (q_t . k_t) v_t leaves out",
     "as[t * LDA + s] = (s <= t) ? acc[i][j] : 0.f;",
     "as[t * LDA + s] = (NORM ? s <= t : s < t) ? acc[i][j] : 0.f;", True),
    ("raw_s0_ignored", "fwd", "starts the raw kernel's S from zero instead of S0",
     "ss[e] = (s0 != nullptr && d < dk && j < dvt)",
     "ss[e] = (NORM && s0 != nullptr && d < dk && j < dvt)", True),
    ("raw_sf_unwritten", "fwd", "never writes the raw kernel's final S",
     "if (j < dvt) sf[s_base + (size_t)d * dv + j0 + j] = ss[e];",
     "if (NORM && j < dvt) sf[s_base + (size_t)d * dv + j0 + j] = ss[e];", True),
    ("raw_rev_seed_dropped", "bwd", "does not seed the raw reverse pass's R with dSf^T",
     "if (p.st0 != nullptr && d < p.dx && j < dwt) {",
     "if ((DEN || ROLE == ROLE_DQ) && p.st0 != nullptr && d < p.dx && j < dwt) {", True),
    ("raw_rev_walks_forward", "bwd",
     "walks the raw reverse pass's chunks first to last (its masks stay anti-causal)",
     "const int c0 = (REV ? n_chunks - 1 - ci : ci) * C;",
     "const int c0 = (REV && DEN ? n_chunks - 1 - ci : ci) * C;", True),
    ("flash_window_off_by_one", "flash_fwd",
     "lets each query see w + 1 keys: t - s <= w for t - s < w",
     "(window <= 0 || row + q_offset - col < window);",
     "(window <= 0 || row + q_offset - col <= window);", True),
    ("flash_bwd_window_off_by_one", "flash_bwd", "the same in both backward kernels' mask",
     "(window <= 0 || row + q_offset - col < window);",
     "(window <= 0 || row + q_offset - col <= window);", True),
    ("flash_causal_dropped", "flash_fwd",
     "drops the causal mask: the diagonal tile's later keys leak in",
     "(!causal || row + q_offset >= col + shift)", "(true)", True),
    ("flash_alpha_one", "flash_fwd",
     "never rescales l and the accumulator when the running max grows (alpha = 1)",
     "const float alpha = expf(m[i] - m_new);", "const float alpha = 1.f;", True),
    ("flash_bf16_probs", "flash_fwd",
     "rounds P to bf16 before P v (the TPU kernel keeps it fp32)",
     "ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;",
     "ps[(ty + 16 * i) * LDP + tx + 16 * j] = __bfloat162float(__float2bfloat16_rn(p));", True),
    ("flash_dq_no_delta", "flash_bwd", "drops - delta from dq's dS",
     "const float ds = p * (dp[i][j] - dl[i]) * scale;",
     "const float ds = p * dp[i][j] * scale;", True),
    ("flash_dkv_stops_at_diagonal", "flash_bwd",
     "ends dk/dv's q-tile loop at the diagonal tile instead of the band's end",
     "hi = min(hi, floor_div(k0 + BK - 1 + window - 1 - q_offset, BQ));",
     "hi = min(hi, floor_div(k0 + BK - 1 - q_offset, BQ));", True),
    # the wgmma route (bf16 at D 128: every model's training shape)
    ("flash_wgmma_lo_dropped", "flash_bwd",
     "drops the low bf16 half of P and dS: both rounded once to bf16 before the second products",
     "const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);",
     "const __nv_bfloat162 l = __floats2bfloat162_rn(0.f * hf.x, 0.f * hf.y);", True),
    # the transpose bit cleared, with the K-major offsets beside it (the
    # MN-major ones would read past the block's shared memory: a fault)
    ("flash_wgmma_dv_transpose_cleared", "flash_bwd",
     "reads dv's MN-major g as K-major in the high half's product (the transpose bit cleared)",
     _DV_HI, _DV_HI.replace("<1>", "<0>").replace("mnmajor(", "kmajor("), True),
    ("flash_wgmma_ring_off_by_one", "flash_bwd",
     "reads the ring's stage before the one whose barrier it waited on (dq)",
     "const uint32_t ks = r.a(s), vs = r.b(s);",
     "const int s2 = (s + STAGES - 1) % STAGES;\n      const uint32_t ks = r.a(s2), vs = r.b(s2);",
     True),
    ("flash_wgmma_window_off_by_one", "flash_bwd",
     "lets each query see w + 1 keys in the wgmma kernels' mask: t - s <= w for t - s < w",
     "(window <= 0 || t - s < window);", "(window <= 0 || t - s <= window);", True),
    ("flash_wgmma_diagonal_as_interior", "flash_bwd",
     "treats the diagonal tile as wholly inside the band, so its mask is skipped",
     "(!causal || s0 + 63 <= t0)", "(!causal || s0 <= t0)", True),
    ("flash_wgmma_dkv_stops_at_diagonal", "flash_bwd",
     "ends dk/dv's q-tile loop at the diagonal tile instead of the band's end (wgmma)",
     "hi = min(hi, (k0 + WROWS - 1 + window - 1) / WT);", "hi = min(hi, (k0 + WROWS - 1) / WT);",
     True),
    ("flash_wgmma_dq_no_delta", "flash_bwd", "drops - delta from dq's dS (wgmma)",
     _DQ_DS, _DQ_DS.replace(" - dl[h]", ""), True),
    ("flash_wgmma_dkv_no_delta", "flash_bwd", "drops - delta from dk's dS^T (wgmma)",
     _DKV_DS, _DKV_DS.replace(" - dl.x", "").replace(" - dl.y", ""), True),
    ("flash_wgmma_lse_row_off", "flash_bwd", "reads each query's lse from the next row (dq)",
     "lse2[h] = t < t_q ? lse[(size_t)bh * t_q + t] * LOG2E : 0.f;",
     "lse2[h] = t < t_q ? lse[(size_t)bh * t_q + min(t + 1, t_q - 1)] * LOG2E : 0.f;", True),
    # the flash forward's wgmma route (row 6, bf16 at D 128)
    ("flash_wgmma_fwd_lo_dropped", "flash_fwd",
     "drops P's low bf16 half: P rounded once to bf16 before P v",
     "kk < WT / 16; ++kk) wgmma_m64n128k16<1>(acc, plo",
     "kk < 0; ++kk) wgmma_m64n128k16<1>(acc, plo", True),
    ("flash_wgmma_fwd_ring_off_by_one", "flash_fwd",
     "reads the ring's stage before the one whose barrier it waited on",
     "const uint32_t ks = r.k(s), vs = r.v(s);",
     "const int s2 = (s + STAGES - 1) % STAGES;\n      const uint32_t ks = r.k(s2), vs = r.v(s2);",
     True),
    ("flash_wgmma_fwd_window_off_by_one", "flash_fwd",
     "lets each query see w + 1 keys in the wgmma kernel's mask: t - s <= w for t - s < w",
     "(window <= 0 || t - s < window);", "(window <= 0 || t - s <= window);", True),
    ("flash_wgmma_fwd_diagonal_as_interior", "flash_fwd",
     "treats the diagonal tile as wholly inside the band, so its mask is skipped",
     "(!causal || s0 + 63 <= t0)", "(!causal || s0 <= t0)", True),
    # the sequence-parallel rings' pieces (shift, q_offset, rows that see no
    # key): rejected by chip_smoke.compare_flash_sp, and run through the sp
    # bodies at sp 4 (``SP_MUTANTS``)
    ("flash_wgmma_fwd_q_offset_dropped", "flash_fwd",
     "drops q_offset from the wgmma forward's moved mask (visible_at): a halo block's queries "
     "taken as at the keys",
     "return t < t_q && s < t_k && (!causal || s + shift <= t + q_offset) &&\n"
     "         (window <= 0 || t + q_offset - s < window);",
     "return t < t_q && s < t_k && (!causal || s + shift <= t) &&\n"
     "         (window <= 0 || t - s < window);", True),
    ("flash_wgmma_shift_dropped", "flash_bwd",
     "drops shift from the wgmma backward kernels' mask: a striped block's diagonal kept",
     "(!causal || s + shift <= t + q_offset)", "(!causal || s <= t + q_offset)", True),
    ("flash_wgmma_dkv_lo_unmoved", "flash_bwd",
     "leaves dk/dv's first q tile unmoved by q_offset (wgmma): a halo block's earlier q tiles "
     "skipped",
     "lo = causal ? max(0, k0 + shift - q_offset) / WT : 0;",
     "lo = causal ? max(0, k0 + shift) / WT : 0;", True),
    ("flash_wgmma_fwd_empty_lse_inf", "flash_fwd",
     "writes lse -inf for a row that sees no key (the ring merge's guard is -5e29)",
     "lse[(size_t)bh * t_q + t] = l[h] == 0.f ? -1e30f :",
     "lse[(size_t)bh * t_q + t] = l[h] == 0.f ? -INFINITY :", True),
    ("flash_empty_lse_nan", "flash_fwd",
     "writes lse NaN for a row that sees no key (simt)",
     "if (tx == 0) lse[(size_t)bh * t_q + row] = m[i] + logf(safe);",
     "if (tx == 0) lse[(size_t)bh * t_q + row] = l[i] == 0.f ? NAN : m[i] + logf(safe);", True),
    ("flash_wgmma_fwd_alpha_one", "flash_fwd",
     "never rescales l and the accumulator when the running max grows (alpha = 1)",
     "alpha[h] = fast_exp2(m[h] - base[h]);", "alpha[h] = 1.f;", True),
    ("flash_wgmma_fwd_lse_row_off", "flash_fwd", "writes each query's lse into the next row",
     "lse[(size_t)bh * t_q + t] = l[h] == 0.f ?",
     "lse[(size_t)bh * t_q + min(t + 1, t_q - 1)] = l[h] == 0.f ?", True),
    # the linear-attention forward's wgmma route (row 1, bf16 at Dk 128)
    ("norm_wgmma_a_lo_dropped", "fwd",
     "drops the low bf16 half of the scores A: A rounded once to bf16 before A v",
     "kk < WC / 16; ++kk) wgmma_m64n64k16_rs<1>(num, alo",
     "kk < 0; ++kk) wgmma_m64n64k16_rs<1>(num, alo", True),
    ("norm_wgmma_s_lo_dropped", "fwd",
     "drops the low bf16 half of the state S: S rounded once to bf16 before q S",
     "for (int kk = 0; kk < WDK / 16; ++kk)\n      wgmma_m64n64k16<0, 1>(num, kmajor(qs, kk), "
     "mnmajor(r.s_lo(), kk));",
     "for (int kk = 0; kk < 0; ++kk)\n      wgmma_m64n64k16<0, 1>(num, kmajor(qs, kk), "
     "mnmajor(r.s_lo(), kk));", True),
    ("norm_wgmma_state_before_qs", "fwd",
     "updates S by the chunk's k^T v and writes its halves before the chunk's q S reads them",
     *_STATE_FIRST, True),
    ("norm_wgmma_z_update_dropped", "fwd", "never adds the chunk's k to z",
     _Z_SUM, _Z_SUM.replace("zs[tid] += acc;", "zs[tid] += 0.f * acc;"), True),
    ("norm_wgmma_den_qz_dropped", "fwd", "drops q . z (the earlier chunks) from den",
     "      den[h] = acc;", "      den[h] = 0.f * acc;", True),
    ("norm_wgmma_mask_one_wider", "fwd", "lets each token see the next one: s <= t + 1",
     "if (col > t) a[j] = 0.f;\n      if (col + 1 > t) a[j + 1] = 0.f;",
     "if (col > t + 1) a[j] = 0.f;\n      if (col + 1 > t + 1) a[j + 1] = 0.f;", True),
    # the linear-attention backward's wgmma route (rows 3 and 4, bf16 at D 128)
    ("bwd_wgmma_a_lo_dropped", "bwd",
     "drops the low bf16 half of the scores A: A rounded once to bf16 before A w",
     "kk < WC / 16; ++kk) wgmma_m64n64k16_rs<1>(o, alo",
     "kk < 0; ++kk) wgmma_m64n64k16_rs<1>(o, alo", True),
    ("bwd_wgmma_st_lo_dropped", "bwd",
     "drops the low bf16 half of the carried state: St rounded once to bf16 before x St",
     _BWD_ST_LO, _BWD_ST_LO.replace("kk < WDX / 16", "kk < 0"), True),
    ("bwd_wgmma_strict_anti", "bwd",
     "masks the reverse pass's scores to s > t: dk and dv lose each token's own term (wgmma)",
     _REV_KEEP, _REV_KEEP.replace(">= t", "> t"), True),
    ("bwd_wgmma_dq_gden_dropped", "bwd",
     "drops gden_t from dq's scores: the in-chunk term gden_t sum_{s<=t} k_s leaves dq (wgmma)",
     "a0 += gt[h];\n        a1 += gt[h];", "", True),
    ("bwd_wgmma_dk_gden_dropped", "bwd",
     "drops gden_s from dk's scores: the in-chunk suffix sum_{s>=t} gden_s q_s leaves dk (wgmma)",
     "a0 += gcur[col];\n        a1 += gcur[col + 1];", "", True),
    ("bwd_wgmma_rev_from_chunk_0", "bwd",
     "walks the reverse pass first chunk to last (its masks stay anti-causal; wgmma)",
     "return (REV ? n_chunks - 1 - c : c) * WC;", "return c * WC;", True),
    ("bwd_wgmma_zr_not_seeded", "bwd", "starts dk's zr from zero instead of gzf (wgmma)",
     "zs[tid] = p.z0 != nullptr ?", "zs[tid] = ROLE == ROLE_DQ && p.z0 != nullptr ?", True),
    ("bwd_wgmma_ds0_unwritten", "bwd", "never writes dS0 from the dv blocks (wgmma)",
     "dz0 (dk)\n  if (p.st_out != nullptr) {", "dz0 (dk)\n  if (false) {", True),
    ("gmm_expert_off_by_one", "gmm", "reads each row tile's expert from the next tile's entry",
     "tile_expert[row0 / tile_rows]", "tile_expert[min(row0 / tile_rows + 1, m / tile_rows - 1)]",
     True),
    ("gmm_transpose_w_ignored", "gmm", "reads w[e] as [K, N] where dx asks for w[e]^T (bf16)",
     "err = transpose_w ? launch_fwd<bf16, true>", "err = false ? launch_fwd<bf16, true>", True),
    ("gmm_k_tail_dropped", "gmm", "drops the last K-step when K is not a multiple of 32",
     "for (int k0 = 0; k0 < k; k0 += BK)", "for (int k0 = 0; k0 + BK <= k; k0 += BK)", True),
    ("gmm_dw_last_tile_missed", "gmm", "walks one row tile fewer of each expert in dw",
     _DW_ROWS, "const int n_rows = (tile_count[e] - 1) * tile_rows;", True),
    ("gmm_dw_absent_unwritten", "gmm", "returns early for an expert without tiles, leaving its "
     "dw unwritten", _DW_ROWS, _DW_ROWS + "\n  if (n_rows == 0) return;", True),
    ("gmm_bf16_accumulator", "gmm", "rounds the fp32 accumulators to bf16 after every 16-deep "
     "product (the TPU kernel accumulates in fp32)",
     "wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);",
     "wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);\n          for (int t = 0; t < "
     "c[i][j].num_elements; ++t) c[i][j].x[t] = "
     "__bfloat162float(__float2bfloat16_rn(c[i][j].x[t]));", True),
    # the wgmma route (bf16 at widths a multiple of 8: every model width)
    ("gmm_wgmma_expert_off_by_one", "gmm",
     "reads each row tile's expert from the next tile's entry (wgmma)",
     "const int e = min(max(tile_expert[tile], 0), n_experts - 1);",
     "const int e = min(max(tile_expert[min(tile + 1, (int)gridDim.x * WM / tile_rows - 1)], 0), "
     "n_experts - 1);", True),
    ("gmm_wgmma_transpose_w_ignored", "gmm",
     "encodes and reads w[e] as [K, N] where dx asks for w[e]^T (wgmma)",
     "transpose_w ? launch_fwd_wgmma<true>", "false ? launch_fwd_wgmma<true>", True),
    ("gmm_wgmma_k_tail_dropped", "gmm", "drops the last K-step when K is not a multiple of 64 "
     "(wgmma)", "const int n_k = (k + WK - 1) / WK;", "const int n_k = k / WK;", True),
    ("gmm_wgmma_dw_last_tile_missed", "gmm", "walks one row tile fewer of each expert in dw "
     "(wgmma)", _DW_STEPS, "const int n_k = (tile_count[e] - 1) * (tile_rows / WK);", True),
    ("gmm_wgmma_dw_absent_unwritten", "gmm", "returns early for an expert without tiles, "
     "leaving its dw unwritten (wgmma)", _DW_STEPS, _DW_STEPS + "\n  if (n_k == 0) return;", True),
    ("gmm_wgmma_bf16_accumulator", "gmm", "rounds the fp32 accumulators to bf16 after every "
     "64-deep step (wgmma)", _WAIT_STEP,
     "    wgmma_wait<0>();\n    for (int i = 0; i < 128; ++i) acc[i] = "
     "__bfloat162float(__float2bfloat16_rn(acc[i]));", True),
    ("gmm_wgmma_ring_off_by_one", "gmm", "reads the ring's stage before the one whose barrier "
     "it waited on", "const uint32_t a = r.a(s) + wg * CHUNK_BYTES, b = r.b(s);",
     "const int s2 = (s + STAGES - 1) % STAGES;\n"
     "    const uint32_t a = r.a(s2) + wg * CHUNK_BYTES, b = r.b(s2);", True),
    ("gmm_wgmma_swizzle_mismatch", "gmm", "lands the operands unswizzled while the wgmma "
     "descriptors read them 128-byte swizzled", "CU_TENSOR_MAP_SWIZZLE_128B",
     "CU_TENSOR_MAP_SWIZZLE_NONE", True),
    # an operand's transpose bit cleared, with the K-major offsets beside it (the
    # MN-major ones would read past the last stage: a fault, not a reading)
    ("gmm_wgmma_b_transpose_cleared", "gmm", "reads the forward's N-major B as K-major (the "
     "transpose bit on B cleared)", _FWD_CONSUME,
     _FWD_CONSUME.replace("<0, 1, KMAJOR_LBO, KMAJOR_STEP, MNMAJOR_LBO, MNMAJOR_STEP>",
                          "<0, 0, KMAJOR_LBO, KMAJOR_STEP, KMAJOR_LBO, KMAJOR_STEP>"), True),
    ("gmm_wgmma_dw_a_transpose_cleared", "gmm", "reads dw's M-major A = x^T as K-major (the "
     "transpose bit on A cleared)", _DW_CONSUME,
     _DW_CONSUME.replace("<1, 1, MNMAJOR_LBO, MNMAJOR_STEP,", "<0, 1, KMAJOR_LBO, KMAJOR_STEP,"),
     True),
    ("q4_lo_hi_swapped", "q4", "takes the low nibble for the odd input row and the high one for "
     "the even", _Q4_UNPACK,
     _Q4_UNPACK.replace("(28 - 8 * c)", "(XX)").replace("(24 - 8 * c)", "(28 - 8 * c)")
     .replace("(XX)", "(24 - 8 * c)"), True),
    ("q4_logical_shift", "q4", "shifts the nibbles down logically: -1 reads as 15, -8 as 8",
     _Q4_UNPACK, _Q4_UNPACK.replace("(int)(w << ", "(w << "), True),
    ("q4_scale_on_rows", "q4", "multiplies by the scale of the row's index, not the channel's",
     "from_f<T>(sum * s[oc])", "from_f<T>(sum * s[r0 + r])", True),
    ("q4_scale_dropped", "q4", "never multiplies by the scale", "from_f<T>(sum * s[oc])",
     "from_f<T>(sum)", True),
    ("q4_k_tail_dropped", "q4", "drops the packed rows past the last whole 512-row chunk",
     "for (int kb = 0; kb < kp; kb += KC)", "for (int kb = 0; kb + KC <= kp; kb += KC)", True),
    ("q4_last_strip_dropped", "q4", "launches no block for a last strip of fewer than 32 channels",
     "const dim3 grid((out + COLS - 1) / COLS);", "const dim3 grid(out / COLS);", True),
    # the int4 dequant-matmul's mma route (row 14, bf16 x at decode's widths)
    ("q4_mma_offset_135", "q4", "subtracts 135 for 136 after the unpack: every nibble reads one "
     "too large", "M_OFFSET = 0xC308C308u;", "M_OFFSET = 0xC307C307u;", True),
    ("q4_mma_offset_137", "q4", "subtracts 137 for 136 after the unpack: every nibble reads one "
     "too small", "M_OFFSET = 0xC308C308u;", "M_OFFSET = 0xC309C309u;", True),
    ("q4_mma_nibbles_swapped", "q4", "puts the high nibble in the fragment's even k and the low "
     "one in the odd", '"r"(w), "r"(hi), "r"(SEL)', '"r"(hi), "r"(w), "r"(SEL)', True),
    ("q4_mma_rank_dropped", "q4", "adds the cluster's partial sums from rank 1 on: rank 0's "
     "share of the packed rows is lost", "for (int q = 0; q < cl; ++q) sum += inbox[q * share + j];",
     "for (int q = 1; q < cl; ++q) sum += inbox[q * share + j];", True),
    ("q4_mma_own_partial_twice", "q4", "adds the block's own partial sum in rank 0's place: its "
     "own twice, rank 0's never", "sum += inbox[q * share + j];",
     "sum += inbox[(q == 0 ? rank : q) * share + j];", True),
    ("q4_mma_k_tail_dropped", "q4", "splits only the whole boxes of 64 packed rows over the "
     "cluster: the rows past the last whole box are lost",
     "args.boxes = (plan.kp + M_BR - 1) / M_BR;", "args.boxes = plan.kp / M_BR;", True),
    ("q4_mma_scale_wrong_channel", "q4", "multiplies each output by its neighbouring channel's "
     "scale", "__float2bfloat16_rn(sum * scale[ch])", "__float2bfloat16_rn(sum * scale[ch ^ 1])",
     True),
    # the public op's raw forward on the wgmma route (row 2, bf16 at Dk 128):
    # the shared walk's text, changed for the raw instance only
    ("raw_wgmma_no_diagonal", "fwd", "masks the raw wgmma kernel's scores to s < t",
     "if (col > t) a[j] = 0.f;\n      if (col + 1 > t) a[j + 1] = 0.f;",
     "if (NORM ? col > t : col >= t) a[j] = 0.f;\n"
     "      if (NORM ? col + 1 > t : col + 1 >= t) a[j + 1] = 0.f;", True),
    ("raw_wgmma_s0_ignored", "fwd", "starts the raw wgmma kernel's S from zero instead of S0",
     "    sa[j] = s0 != nullptr ? s0[s_base + (size_t)m * dv + n] : 0.f;\n"
     "    sb[j] = s0 != nullptr ? s0[s_base + (size_t)(m + 64) * dv + n] : 0.f;",
     "    sa[j] = NORM && s0 != nullptr ? s0[s_base + (size_t)m * dv + n] : 0.f;\n"
     "    sb[j] = NORM && s0 != nullptr ? s0[s_base + (size_t)(m + 64) * dv + n] : 0.f;", True),
    ("raw_wgmma_sf_unwritten", "fwd", "never writes the raw wgmma kernel's final S",
     "for (int j = 0; (NORM || sf != nullptr) && j < 32; j += 2) {",
     "for (int j = 0; NORM && j < 32; j += 2) {", True),
    ("raw_wgmma_a_lo_dropped", "fwd",
     "drops the low bf16 half of the raw kernel's scores A: A rounded once before A v",
     "kk < WC / 16; ++kk) wgmma_m64n64k16_rs<1>(num, alo",
     "kk < (NORM ? WC / 16 : 0); ++kk) wgmma_m64n64k16_rs<1>(num, alo", True),
    ("raw_wgmma_s_lo_dropped", "fwd",
     "drops the low bf16 half of the raw kernel's state S: S rounded once before q S",
     "for (int kk = 0; kk < WDK / 16; ++kk)\n      wgmma_m64n64k16<0, 1>(num, kmajor(qs, kk), "
     "mnmajor(r.s_lo(), kk));",
     "for (int kk = 0; kk < (NORM ? WDK / 16 : 0); ++kk)\n      wgmma_m64n64k16<0, 1>(num, "
     "kmajor(qs, kk), mnmajor(r.s_lo(), kk));", True),
    # the public op's raw reverse pass on the wgmma route (row 5, bf16 at
    # Dk = Dv = 128): the walk's text, changed for the raw instance only
    ("raw_wgmma_rev_seed_dropped", "bwd",
     "does not seed the raw wgmma reverse pass's R with dSf^T (dS0 loses it too)",
     "if (p.st0 != nullptr && ROLE == ROLE_DV) {",
     "if (sizeof(TO) == 4) {\n    } else if (p.st0 != nullptr && ROLE == ROLE_DV) {", True),
    ("raw_wgmma_rev_seed_untransposed", "bwd",
     "seeds the raw wgmma dk role's R with dSf as laid out instead of dSf^T",
     _DK_SEED,
     "      sa[j] = sizeof(TO) == 4 ? p.st0[s_base + (size_t)m * p.dw + n]\n"
     "                              : p.st0[s_base + (size_t)n * WDX + m];\n"
     "      sb[j] = sizeof(TO) == 4 ? p.st0[s_base + (size_t)(m + 64) * p.dw + n]\n"
     "                              : p.st0[s_base + (size_t)n * WDX + m + 64];", True),
    ("raw_wgmma_rev_walks_forward", "bwd",
     "walks the raw wgmma reverse pass's chunks first to last (its masks stay anti-causal)",
     "return (REV ? n_chunks - 1 - c : c) * WC;",
     "return (REV && sizeof(TO) == 2 ? n_chunks - 1 - c : c) * WC;", True),
    ("raw_wgmma_rev_strict_anti", "bwd",
     "masks the raw wgmma reverse pass's scores to s > t: each token's own term leaves dk, dv",
     _REV_KEEP,
     _REV_KEEP.replace("REV ? col >= t", "REV ? (sizeof(TO) == 4 ? col > t : col >= t)")
     .replace("REV ? col + 1 >= t", "REV ? (sizeof(TO) == 4 ? col + 1 > t : col + 1 >= t)"),
     True),
    ("raw_wgmma_rev_a_lo_dropped", "bwd",
     "drops the low bf16 half of the raw reverse pass's scores A: A rounded once before A w",
     "kk < WC / 16; ++kk) wgmma_m64n64k16_rs<1>(o, alo",
     "kk < (sizeof(TO) == 2 ? WC / 16 : 0); ++kk) wgmma_m64n64k16_rs<1>(o, alo", True),
    ("raw_wgmma_rev_r_lo_dropped", "bwd",
     "drops the low bf16 half of the raw reverse pass's R: R rounded once before x R",
     _BWD_ST_LO, _BWD_ST_LO.replace("kk < WDX / 16", "kk < (sizeof(TO) == 2 ? WDX / 16 : 0)"),
     True),
    ("raw_wgmma_rev_bf16_store", "bwd",
     "rounds the raw reverse pass's fp32 dk and dv through bf16 on their way out",
     "*reinterpret_cast<float2*>(out) = make_float2(a, b);",
     "*reinterpret_cast<float2*>(out) = make_float2(__bfloat162float(__float2bfloat16_rn(a)),\n"
     "                                                __bfloat162float(__float2bfloat16_rn(b)));",
     True),
    ("raw_wgmma_rev_ds0_unwritten", "bwd", "never writes dS0 from the raw wgmma dv blocks",
     "dz0 (dk)\n  if (p.st_out != nullptr) {",
     "dz0 (dk)\n  if (sizeof(TO) == 2 && p.st_out != nullptr) {", True),
    ("af_sums_swapped", "adafactor", "writes the row sums where the column sums go and back",
     _AF_FINAL, _AF_FINAL.replace("sums[n + i]", "sums[i]").replace("sums[j]", "sums[m + j]"),
     True),
    ("af_eps_dropped", "adafactor", "drops eps from q = g g s2 + eps",
     "__fadd_rn(__fmul_rn(__fmul_rn(v[k][i], v[k][i]), s2), eps)",
     "__fmul_rn(__fmul_rn(v[k][i], v[k][i]), s2)", True),
    ("af_sums_last_chunk_missed", "adafactor", "leaves the last row chunk out of the column sums",
     "t.n_ct, t.n_rc);\n", "t.n_ct, t.n_rc - 1);\n", True),
    ("af_rms_last_chunk_missed", "adafactor", "leaves the last row chunk's partials out of the "
     "squared sum", "af_rms_finalize<<<1, NT, 0, st>>>(part, t.n_ct * t.n_rc,",
     "af_rms_finalize<<<1, NT, 0, st>>>(part, t.n_ct * (t.n_rc - 1),", True),
    ("af_sums_scaled", "adafactor", "writes every row and column sum 1 % too large (a constant "
     "factor: the row and column factors' ratios, and so the update's direction, unchanged)",
     _AF_FINAL, _AF_FINAL.replace("sums[n + i] = t;", "sums[n + i] = t * 1.01f;")
     .replace("sums[j] = t;", "sums[j] = t * 1.01f;"), True),
    ("af_flag_ignored", "adafactor", "applies the update on a non-finite step",
     "  if (*flag == 0) return;  // a non-finite step: p stays as it was\n", "", True),
]


def _clear_libs():
    for mod in (causal_dot, flash_attention, gmm, q4_matmul, adafactor):
        mod._libs.clear()  # load the libraries of the modules' SOURCES anew


def run(name, source, dev):
    _clear_libs()
    if name.startswith("raw_") or source == "raw":
        readings, _ = chip_smoke.compare_raw(causal_dot, dev)
        accepted = all(chip_smoke.agrees_raw(r) for r in readings)
        for r in readings:
            chip_smoke.log(
                f"  {r['case']}: " + "; ".join(
                    f"{n} {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3g} of its limit)"
                    for n in ("out", "dq", "dk", "dv"))
                + f"; S rel {r['s_rel']:.3e}, dS0 rel {r['ds0_rel']:.3e}")
    elif source == "q4":
        readings, _ = chip_smoke.compare_q4(q4_matmul, dev)
        accepted = all(chip_smoke.agrees_q4(r) for r in readings)
        for r in readings:
            chip_smoke.log(f"  {r['case']}: y {r['y']['max_abs']:.3e} "
                           f"({r['y']['over_limit']:.3g} of its limit)")
    elif source == "adafactor":
        readings, _ = chip_smoke.compare_adafactor(adafactor, dev)
        accepted = all(chip_smoke.agrees_adafactor(r) for r in readings)
        for r in readings:
            chip_smoke.log(
                f"  {r['case']}: sums rel {r['sums_rel']:.3g} "
                f"({r['sums_rel'] / chip_smoke.AF_SUM_RTOL:.3g} of its limit), squared sum rel "
                f"{r['rms_rel']:.3g} ({r['rms_rel'] / chip_smoke.AF_RMS_RTOL:.3g} of its limit), "
                f"apply {r['apply_over_limit']:.3g} of its limit, flag 0 leaves p bitwise: "
                f"{r['flag_off_untouched']}")
        # the main path's end-to-end check, one update at lm_1b3's shapes
        update = chip_smoke.compare_adafactor_update(adafactor, dev)
        chip_smoke._log_update("  one update", update)
        readings = readings + [{"case": "one update", **update}]
        accepted = accepted and update["agrees"]
    elif source == "gmm":
        readings, _ = chip_smoke.compare_gmm(gmm, dev)
        accepted = all(chip_smoke.agrees_gmm(r) for r in readings)
        for r in readings:
            chip_smoke.log(
                f"  {r['case']}: " + "; ".join(
                    f"{n} {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3g} of its limit)"
                    for n in ("y", "dx", "dw"))
                + f"; absent expert's dw exactly 0: {r['dw']['absent_zero']}")
    elif source.startswith("flash"):
        readings, _ = chip_smoke.compare_flash(flash_attention, dev)
        accepted = all(chip_smoke.agrees_flash(r) for r in readings)
        # the sp rings' blocks: shift, q_offset, rows that see no key
        readings_sp, _ = chip_smoke.compare_flash_sp(flash_attention, dev)
        accepted = accepted and all(chip_smoke.agrees_flash_sp(r) for r in readings_sp)
        for r in readings + readings_sp:
            chip_smoke.log(
                f"  {r['case']} (backward {r['variant']}): " + "; ".join(
                    f"{n} {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3g} of its limit)"
                    for n in ("out", "dq", "dk", "dv"))
                + f"; lse {r['lse_max_abs']:.3e} ({r['lse_over_limit']:.3g} of its limit)"
                + (f"; empty rows {r['empty_rows']}, guard held {r['empty_ok']}"
                   if "empty_ok" in r else ""))
        readings = readings + readings_sp
        if name in SP_MUTANTS or name == "sound":
            # the sp bodies at sp 4, T 2048 (h = 2), this copy of the flash
            # sources in every rank
            paths = [("fa", k, str(p)) for k, p in flash_attention.SOURCES.items()]
            ranks = chip_smoke.sp_spawn(4, chip_smoke.sp_bodies_rank,
                                        {"t": 2048, "window": 1024, "seed": 22, "sources": paths})
            for body in ranks[0]:
                ok = all(chip_smoke.agrees_sp_body(r[body]) for r in ranks)
                chip_smoke.log(f"  sp body {body} at sp 4, T 2048: " + "; ".join(
                    f"{n} {max(r[body][n]['over_limit'] for r in ranks):.3g} of its limit"
                    for n in ("out", "dq", "dk", "dv")) + f": {'within' if ok else 'outside'}")
                readings.append({"case": f"sp body {body}", "agrees": ok})
    elif source == "fwd":
        readings, _ = chip_smoke.compare_causal_dot(causal_dot, dev)
        accepted = all(chip_smoke.agrees(r) for r in readings)
        for r in readings:
            chip_smoke.log(f"  {r['case']}: out max abs {r['out_max_abs']:.3e}, "
                           f"{r['out_over_limit']:.3f} of its limit; S rel {r['s_rel']:.3e}, "
                           f"z rel {r['z_rel']:.3e}")
        readings_t, _ = chip_smoke.compare_training_kernels(causal_dot, dev)
        accepted = accepted and all(chip_smoke.agrees_training(r) for r in readings_t)
        for r in readings_t:
            chip_smoke.log(f"  {r['case']}: num rel {r['num_rel']:.3e}, den rel {r['den_rel']:.3e}")
        readings = readings + readings_t
    else:
        readings, _ = chip_smoke.compare_training_kernels(causal_dot, dev)
        accepted = all(chip_smoke.agrees_training(r) for r in readings)
        for r in readings:
            chip_smoke.log(
                f"  {r['case']}: " + "; ".join(
                    f"{n} {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3g} of its limit)"
                    for n in ("dq", "dk", "dv"))
                + f"; dS0 rel {r['ds0_rel']:.3e}, dz0 rel {r['dz0_rel']:.3e}")
    chip_smoke.log(f"{name}: {'accepted' if accepted else 'rejected'}")
    return {"name": name, "source": source, "accepted": accepted, "readings": readings}


_FUNCTION = re.compile(r"^\s*Function : (\S+)\s*$", re.MULTILINE)


def _sass(lib):
    """{kernel's name and template arguments: its SASS text} of a built
    library (the parameter types left out, so a kernel whose parameter
    struct became a template instance still matches its old self)."""
    tools = Path(library._nvcc()).parent
    text = subprocess.run([str(tools / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    parts = _FUNCTION.split(text)
    names = subprocess.run([str(tools / "cu++filt"), *parts[1::2]], capture_output=True,
                           text=True, check=True, timeout=60).stdout.splitlines()
    return {n.split("(")[0].strip(): body for n, body in zip(names, parts[2::2], strict=True)}


def sass_against(other):
    """Build every source of ``SOURCES`` from this checkout and from the
    checkout ``other`` (its ``orion_tpu_torch/csrc/``, its own headers) with
    the library's nvcc command, disassemble both with ``cuobjdump -sass``
    and match the kernels by name and template arguments: per source, the
    kernels whose SASS text is identical, those that differ, and those in
    only one checkout."""
    out = library.BUILD_DIR / "sass"
    jobs = []
    for key, (mod, src_key) in SOURCES.items():
        here = mod.SOURCES[src_key]
        for side, csrc in (("here", library.CSRC), ("there", Path(other) / "orion_tpu_torch/csrc")):
            (out / side).mkdir(parents=True, exist_ok=True)
            cmd = library._build_command(csrc / here.name, out / side / f"{here.stem}.so")
            jobs.append((key, side, [str(csrc) if c == str(library.CSRC) else c for c in cmd]))
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc for each source, all at once
        list(pool.map(lambda j: subprocess.run(j[2], capture_output=True, check=True,
                                               timeout=600), jobs))
    report = {}
    for key, (mod, src_key) in SOURCES.items():
        stem = mod.SOURCES[src_key].stem
        here, there = (_sass(out / side / f"{stem}.so") for side in ("here", "there"))
        report[key] = {
            "identical": sorted(n for n in here if n in there and here[n] == there[n]),
            "differ": sorted(n for n in here if n in there and here[n] != there[n]),
            "only_here": sorted(set(here) - set(there)),
            "only_there": sorted(set(there) - set(here))}
        for what, names in report[key].items():
            for n in names:
                print(f"{stem}: {what}: {n}")
    print(json.dumps({"sass_against": str(other), "sources": report}))
    return 0


# the genmesh part's mesh mutant: each rank quantizes its own tp shard, so a
# row-parallel int4 scale (wo, down) is the max over the rank's slice of the
# input instead of over the whole input (``generate.quantize_for_decode``
# quantizes whole leaves, then cuts); run at G4's int4 dp 2 x tp 2
GENMESH_MUTANT = "q4_row_scale_of_the_shard"
GENMESH_RUN = next(run for run in chip_smoke.GENMESH_4 if run[5] == "int4")


def _shard_quantize(model, mode):
    """The mutant's ``quantize_for_decode``: each rank's shard of every leaf
    quantized by itself."""
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.quant import quantize_params_for_decode

    qmodel = TransformerLM(model.cfg, device=model.device, quant=mode, mesh=model.mesh)
    qmodel.load_state_dict(quantize_params_for_decode(qmodel, model.state_dict()), strict=True)
    return qmodel


def genmesh_mutant_rank(mesh, payload):
    """One rank: G4's int4 run with the sound quantization, then with the
    mutant's -> {"sound": readings, "mutant": readings}."""
    from orion_tpu_torch import generate

    out = {"sound": chip_smoke.genmesh_rank(mesh, {**payload, "genmesh": (GENMESH_RUN,)})}
    sound = generate.quantize_for_decode
    generate.quantize_for_decode = _shard_quantize
    try:
        out["mutant"] = chip_smoke.genmesh_rank(mesh, {**payload, "genmesh": (GENMESH_RUN,)})
    finally:
        generate.quantize_for_decode = sound
    return out


def genmesh_mutants(dev) -> int:
    """The sound G4 int4 run and its mutant on 4 ranks sharing the card:
    ``chip_smoke.genmesh_verdict`` must accept the first and reject the
    second. Exits nonzero otherwise."""
    from orion_tpu_torch.parallel.mesh import MeshConfig

    ranks = chip_smoke.sp_spawn(4, genmesh_mutant_rank, {}, timeout=900, mesh=MeshConfig(dp=4))
    verdicts = {}
    for kind in ("sound", "mutant"):
        chip_smoke.log(f"genmesh {kind}:")
        try:
            chip_smoke.genmesh_verdict(GENMESH_RUN[0], [r[kind][GENMESH_RUN[0]] for r in ranks])
            verdicts[kind] = {"accepted": True}
        except AssertionError as e:
            verdicts[kind] = {"accepted": False, "why": str(e)[:2000]}
    worst = {kind: {"logits_err": max(max(r[kind][GENMESH_RUN[0]]["logits_err"]) for r in ranks),
                    "s_err": max(max(e or 0.0 for e in r[kind][GENMESH_RUN[0]]["s_err"])
                                 for r in ranks)}
             for kind in verdicts}
    chip_smoke.log(json.dumps({"genmesh_mutant": GENMESH_MUTANT, "run": GENMESH_RUN[0],
                               "limits": {"logits_atol": chip_smoke.TP_LOGITS_ATOL,
                                          "s_rtol": chip_smoke.TP_S_RTOL,
                                          "kv_rtol": chip_smoke.TP_KV_RTOL},
                               "verdicts": verdicts, "readings": worst}))
    return 0 if verdicts["sound"]["accepted"] and not verdicts["mutant"]["accepted"] else 1


# the combos part's mutants, (name, must the limits reject it): (M3) each
# rank's dropout masks drawn at its own shape, rows and tokens from 0; (M1)
# a MoE layer's load-balance statistics over the rank's own tokens
COMBOS_MUTANTS = {"M3": ("masks_at_the_rank_shape", True),
                  "M1": ("moe_stats_of_the_rank", False)}


class _ComboMutant:
    """Within ``with``: the port with mutant ``kind`` (``COMBOS_MUTANTS``)."""

    def __init__(self, kind):
        from orion_tpu_torch.models import moe, transformer

        self.kind, self.moe, self.tf = kind, moe, transformer
        self.real = (transformer.dropout_keep, moe.all_reduce_mean)

    def __enter__(self):
        keep, _ = self.real
        if self.kind == "M3":
            self.tf.dropout_keep = lambda key, site, shape, rate, device=None: keep(
                self.tf.DropoutKey(key.seed), site, shape, rate, device)
        else:
            self.moe.all_reduce_mean = lambda x, group: x
        return self

    def __exit__(self, *exc):
        self.tf.dropout_keep, self.moe.all_reduce_mean = self.real


def combos_mutant_rank(mesh, payload):
    """One rank: the combos runs of ``payload["runs"]`` as they are, then
    under the mutant ``payload["kind"]`` -> {"sound": ..., "mutant": ...}
    (``dp_train_rank``'s results)."""
    out = {"sound": chip_smoke.dp_train_rank(mesh, payload)}
    with _ComboMutant(payload["kind"]):
        out["mutant"] = chip_smoke.dp_train_rank(mesh, payload)
    return out


def combos_mutants() -> int:
    """M1's and M3's sound runs and their mutants: every sound run must be
    accepted by ``chip_smoke.combos_train_verdict``, every mutant run that
    ``COMBOS_MUTANTS`` marks rejected. Exits nonzero otherwise."""
    from orion_tpu_torch.parallel.mesh import MeshConfig

    verdicts = {}
    for kind, world, runs in (("M1", 2, chip_smoke.COMBOS_TRAIN_2),
                              ("M3", 4, chip_smoke.COMBOS_TRAIN_4)):
        ranks = chip_smoke.sp_spawn(world, combos_mutant_rank, {"runs": runs, "kind": kind},
                                    timeout=1200, mesh=MeshConfig(dp=world))
        for name, _, _, meshes, opts in runs:
            for shape in meshes:
                label = chip_smoke._mesh_label(name, shape)
                for which in ("sound", "mutant"):
                    chip_smoke.log(f"combos {kind} {which} {label}:")
                    try:
                        chip_smoke.combos_train_verdict(label, [r[which][label] for r in ranks],
                                                        opts)
                        v = {"accepted": True}
                    except AssertionError as e:
                        v = {"accepted": False, "why": str(e)[:2000]}
                    verdicts[f"{kind} {which} {label}"] = v
    chip_smoke.log(json.dumps({"combos_mutants": COMBOS_MUTANTS, "verdicts": verdicts}))
    ok = all(v["accepted"] if k.split()[1] == "sound"
             else not (COMBOS_MUTANTS[k.split()[0]][1] and v["accepted"])
             for k, v in verdicts.items())
    return 0 if ok else 1


def main() -> int:
    if "--sass-against" in sys.argv[1:]:  # compare code with another checkout's, no card needed
        return sass_against(sys.argv[sys.argv.index("--sass-against") + 1])
    if "--genmesh" in sys.argv[1:]:
        if not torch.cuda.is_available():
            print("kernel_mutants: needs a CUDA card", file=sys.stderr)
            return 1
        chip_smoke.card_info()
        chip_smoke.build((causal_dot, flash_attention, gmm, q4_matmul, adafactor))
        return genmesh_mutants(torch.device("cuda", 0))
    if "--combos" in sys.argv[1:]:
        if not torch.cuda.is_available():
            print("kernel_mutants: needs a CUDA card", file=sys.stderr)
            return 1
        chip_smoke.card_info()
        chip_smoke.build((causal_dot, flash_attention, gmm, q4_matmul, adafactor))
        return combos_mutants()
    if not torch.cuda.is_available():
        print("kernel_mutants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    chip_smoke.card_info()
    sound = {k: mod.SOURCES[key] for k, (mod, key) in SOURCES.items()}
    texts = {k: p.read_text() for k, p in sound.items()}
    header = (library.CSRC / HEADER).read_text()
    mutant_dir = library.BUILD_DIR / "mutants"
    mutant_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, source, _, old, new, _ in MUTANTS:
        text = texts[source]
        if text.count(old) == 1:
            paths[name] = mutant_dir / f"{sound[source].stem}_{name}.cu"
            paths[name].write_text(text.replace(old, new))
        elif text.count(old) == 0 and header.count(old) == 1 and f'#include "{HEADER}"' in text:
            own = mutant_dir / name  # the source beside its patched header
            own.mkdir(exist_ok=True)
            (own / HEADER).write_text(header.replace(old, new))
            paths[name] = own / sound[source].name
            paths[name].write_text(text)
        else:
            raise RuntimeError(f"mutant {name}: its text is not once in {sound[source]} "
                               f"or, failing that, in the {HEADER} it includes")
    builds = list(sound.values()) + list(paths.values())
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc for each source, all at once
        list(pool.map(library.build, builds))

    results = [run("sound", src, dev) for src in ("fwd", "bwd", "raw", "flash_fwd", "gmm", "q4",
                                                  "adafactor")]
    ok = all(r["accepted"] for r in results)
    for name, source, breaks, _, _, must_reject in MUTANTS:
        mod, key = SOURCES[source]
        mod.SOURCES[key] = paths[name]
        chip_smoke.log(f"{name} ({breaks}):")
        r = run(name, source, dev)
        r.update(breaks=breaks, must_reject=must_reject)
        results.append(r)
        ok = ok and not (must_reject and r["accepted"])
        mod.SOURCES[key] = sound[source]
    _clear_libs()
    chip_smoke.log(json.dumps({
        "limits": {"out_rtol": chip_smoke.OUT_RTOL, "out_atol": chip_smoke.OUT_ATOL,
                   "state_rtol": chip_smoke.STATE_RTOL, "grad_rtol": chip_smoke.GRAD_RTOL,
                   "raw_rtol": {str(k): v for k, v in chip_smoke.RAW_RTOL.items()},
                   "raw_atol_of_max": chip_smoke.RAW_ATOL_OF_MAX,
                   "grad_atol_of_max": chip_smoke.GRAD_ATOL_OF_MAX,
                   "flash_rtol": {str(k): v for k, v in chip_smoke.FLASH_RTOL.items()},
                   "flash_atol_of_max": chip_smoke.FLASH_ATOL_OF_MAX,
                   "flash_grad_floor": chip_smoke.FLASH_GRAD_FLOOR,
                   "lse_rtol": chip_smoke.LSE_RTOL,
                   "gmm_rtol": {str(k): v for k, v in chip_smoke.GMM_RTOL.items()},
                   "gmm_atol_of_max": chip_smoke.GMM_ATOL_OF_MAX,
                   "gmm_dw_rtol_of_max": chip_smoke.GMM_DW_RTOL_OF_MAX,
                   "q4_rtol": {str(k): v for k, v in chip_smoke.Q4_RTOL.items()},
                   "q4_atol_of_max": chip_smoke.Q4_ATOL_OF_MAX,
                   "af_sum_rtol": chip_smoke.AF_SUM_RTOL, "af_rms_rtol": chip_smoke.AF_RMS_RTOL,
                   "af_apply_rtol": chip_smoke.AF_APPLY_RTOL,
                   "af_param_rtol": chip_smoke.AF_PARAM_RTOL,
                   "af_param_atol": chip_smoke.AF_PARAM_ATOL,
                   "af_stat_atol_of_max": chip_smoke.AF_STAT_ATOL_OF_MAX},
        "kernels": results,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
