"""Which wrong kernels ``chip_smoke.py``'s agreement limits reject.

    python3 kernel_mutants.py

On a machine with one CUDA card and ``nvcc``. Builds the sound kernels and
deliberately wrong copies of them, each made by one textual edit of
``orion_tpu_torch/csrc/causal_dot_norm.cu`` (the forward) or
``causal_dot_bwd.cu`` (the two backward kernels), written under
``orion_tpu_torch/_build/mutants/`` (the sources in the checkout are never
changed); all the builds start together, one nvcc each. Then it holds each
copy against the plain versions with ``chip_smoke.compare_causal_dot``
(forward copies, at the generate path's shape) or
``chip_smoke.compare_training_kernels`` (backward copies, at the training
shape), prints, per kernel, its readings and whether ``chip_smoke.agrees`` /
``chip_smoke.agrees_training`` accepts it, then all of it as one JSON line.
Exits nonzero if a sound kernel is rejected or a kernel that must be
rejected is not. Imports nothing of JAX.
"""

import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke
from orion_tpu_torch.ops.kernels import causal_dot

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
     "make_walk<T>(v, g, q, gden, gsf, 1, gzf, dk_out, nullptr, dz0, dv, dk);",
     "make_walk<T>(v, g, q, gden, gsf, 1, nullptr, dk_out, nullptr, dz0, dv, dk);", True),
    ("dsf_not_seeded", "bwd", "does not seed R with dSf^T in the reverse pass",
     "if (p.st0 != nullptr && d < p.dx && j < dwt) {",
     "if (ROLE == ROLE_DQ && p.st0 != nullptr && d < p.dx && j < dwt) {", True),
    ("dq_gden_dropped", "bwd",
     "drops the in-chunk denominator term gden_t sum_{s<=t} k_s from dq",
     "if (ROLE == ROLE_DQ) v += gds[t];", "", True),
    ("dk_gden_dropped", "bwd",
     "drops the in-chunk denominator term sum_{s>=t} gden_s q_s from dk",
     "if (ROLE == ROLE_DK) v += gds[s];", "", True),
    ("dq_z0_ignored", "bwd", "starts dq's prefix z from zero instead of z0",
     "zs[j] = (p.z0 != nullptr && j < dwt)",
     "zs[j] = (ROLE == ROLE_DK && p.z0 != nullptr && j < dwt)", True),
]


def run(name, source, dev):
    causal_dot._libs.clear()  # load the libraries built from causal_dot.SOURCES
    if source == "fwd":
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
    sound = dict(causal_dot.SOURCES)
    texts = {k: p.read_text() for k, p in sound.items()}
    mutant_dir = causal_dot.BUILD_DIR / "mutants"
    mutant_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, source, _, old, new, _ in MUTANTS:
        if texts[source].count(old) != 1:
            raise RuntimeError(f"mutant {name}: its text is not once in {sound[source]}")
        paths[name] = mutant_dir / f"{sound[source].stem}_{name}.cu"
        paths[name].write_text(texts[source].replace(old, new))
    builds = list(sound.values()) + list(paths.values())
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc for each source, all at once
        list(pool.map(causal_dot.build, builds))

    results = [run("sound", "fwd", dev), run("sound", "bwd", dev)]
    ok = all(r["accepted"] for r in results)
    for name, source, breaks, _, _, must_reject in MUTANTS:
        causal_dot.SOURCES[source] = paths[name]
        chip_smoke.log(f"{name} ({breaks}):")
        r = run(name, source, dev)
        r.update(breaks=breaks, must_reject=must_reject)
        results.append(r)
        ok = ok and not (must_reject and r["accepted"])
        causal_dot.SOURCES[source] = sound[source]
    causal_dot._libs.clear()
    chip_smoke.log(json.dumps({
        "limits": {"out_rtol": chip_smoke.OUT_RTOL, "out_atol": chip_smoke.OUT_ATOL,
                   "state_rtol": chip_smoke.STATE_RTOL, "grad_rtol": chip_smoke.GRAD_RTOL,
                   "grad_atol_of_max": chip_smoke.GRAD_ATOL_OF_MAX},
        "kernels": results,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
