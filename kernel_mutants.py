"""Which wrong kernels ``chip_smoke.py``'s agreement limits reject.

    python3 kernel_mutants.py

On a machine with one CUDA card and ``nvcc``. Builds the sound kernels and
deliberately wrong copies of them, each made by one textual edit of a
source in ``orion_tpu_torch/csrc/``: ``causal_dot_norm.cu`` ("fwd", the
linear forward and the public op's raw forward), ``causal_dot_bwd.cu``
("bwd", the backward kernels of both),
``flash_attention.cu`` ("flash_fwd"), ``flash_attention_bwd.cu``
("flash_bwd", dq and dk/dv), ``gmm.cu`` ("gmm", the grouped matmul's
forward and dw), ``q4_matmul.cu`` ("q4", the int4 dequant-matmul) or
``adafactor.cu`` ("adafactor", the fused Adafactor's three passes), written
under
``orion_tpu_torch/_build/mutants/`` (the sources in the checkout are never
changed); all the builds start together, one nvcc each. Then it holds each
copy against the plain versions with ``chip_smoke.compare_causal_dot``
(linear forward copies, at the generate path's shape),
``chip_smoke.compare_raw`` (the copies named ``raw_*``, of the public op's
two kernels, on all its cases),
``chip_smoke.compare_training_kernels`` (linear backward copies, at the
training shape), ``chip_smoke.compare_flash`` (flash copies, on all its
cases), ``chip_smoke.compare_gmm`` (gmm copies, on all its cases),
``chip_smoke.compare_q4`` or ``chip_smoke.compare_adafactor`` (on all their
cases; Adafactor copies also through ``chip_smoke.compare_adafactor_update``,
one update against the plain formulas), prints, per kernel, its readings and whether ``chip_smoke.agrees`` /
``agrees_training`` / ``agrees_raw`` / ``agrees_flash`` / ``agrees_gmm`` / ``agrees_q4`` /
``agrees_adafactor`` accepts it, then all of it as one JSON line. Exits nonzero if a sound kernel is rejected or a kernel that
must be rejected is not. Imports nothing of JAX.
"""

import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke
from orion_tpu_torch.ops.kernels import adafactor, causal_dot, flash_attention, gmm, library
from orion_tpu_torch.ops.kernels import q4_matmul

# source name -> (wrapper module, its SOURCES key)
SOURCES = {"fwd": (causal_dot, "fwd"), "bwd": (causal_dot, "bwd"),
           "flash_fwd": (flash_attention, "fwd"), "flash_bwd": (flash_attention, "bwd"),
           "gmm": (gmm, "gmm"), "q4": (q4_matmul, "q4"), "adafactor": (adafactor, "adafactor")}
_DW_ROWS = "const int n_rows = tile_count[e] * tile_rows;"
_AF_FINAL = ("    sums[n + i] = t;\n  } else if (i < m + n) {\n    const int j = i - m;\n"
             "    float t = 0.f;\n    for (int rc = 0; rc < n_rc; ++rc) t += colpart[(size_t)rc * n + j];\n"
             "    sums[j] = t;")
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
     "(window <= 0 || row - col < window);", "(window <= 0 || row - col <= window);", True),
    ("flash_bwd_window_off_by_one", "flash_bwd", "the same in both backward kernels' mask",
     "(window <= 0 || row - col < window);", "(window <= 0 || row - col <= window);", True),
    ("flash_causal_dropped", "flash_fwd",
     "drops the causal mask: the diagonal tile's later keys leak in",
     "(!causal || row >= col)", "(true)", True),
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
     "hi = min(hi, (k0 + BK - 1 + window - 1) / BQ);", "hi = min(hi, (k0 + BK - 1) / BQ);",
     True),
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
        for r in readings:
            chip_smoke.log(
                f"  {r['case']}: " + "; ".join(
                    f"{n} {r[n]['max_abs']:.3e} ({r[n]['over_limit']:.3g} of its limit)"
                    for n in ("out", "dq", "dk", "dv"))
                + f"; lse {r['lse_max_abs']:.3e} ({r['lse_over_limit']:.3g} of its limit)")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_mutants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    chip_smoke.card_info()
    sound = {k: mod.SOURCES[key] for k, (mod, key) in SOURCES.items()}
    texts = {k: p.read_text() for k, p in sound.items()}
    mutant_dir = library.BUILD_DIR / "mutants"
    mutant_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, source, _, old, new, _ in MUTANTS:
        if texts[source].count(old) != 1:
            raise RuntimeError(f"mutant {name}: its text is not once in {sound[source]}")
        paths[name] = mutant_dir / f"{sound[source].stem}_{name}.cu"
        paths[name].write_text(texts[source].replace(old, new))
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
