"""Which wrong kernels ``chip_smoke.py``'s agreement limits reject.

    python3 kernel_mutants.py

On a machine with one CUDA card and ``nvcc``. Builds the sound
``causal_dot_norm`` kernel and a few deliberately wrong copies of it, each
made by one textual edit of ``orion_tpu_torch/csrc/causal_dot_norm.cu`` and
written and built under ``orion_tpu_torch/_build/mutants/`` (the source in
the checkout is never changed). Holds each against the plain version with
``chip_smoke.compare_causal_dot`` and prints, per kernel, its readings and
whether ``chip_smoke.agrees`` accepts it, then all of it as one JSON line.
Exits nonzero if the sound kernel is rejected or a kernel that must be
rejected is not. Imports nothing of JAX.
"""

import json
import sys

import torch

import chip_smoke
from orion_tpu_torch.ops.kernels import causal_dot

# (name, what it breaks, text of the source, its replacement, must be rejected)
MUTANTS = [
    ("no_diagonal", "masks the scores to s < t: each token's own k_t v_t leaves num and den",
     "as[t * LDA + s] = (s <= t) ? acc[i][j] : 0.f;",
     "as[t * LDA + s] = (s < t) ? acc[i][j] : 0.f;", True),
    ("state_skips_last_row", "leaves each chunk's last token out of the carried S",
     "for (int s = 0; s < rows; ++s) {\n        float a[8], b[4];",
     "for (int s = 0; s < rows - 1; ++s) {\n        float a[8], b[4];", True),
    ("z0_ignored", "starts z from zero instead of z0",
     "zs[d] = (z0 != nullptr && d < dk) ? z0[(size_t)bh * dk + d] : 0.f;",
     "zs[d] = 0.f;", True),
    ("bf16_scores", "rounds the masked scores to bf16 (the TPU kernel keeps them fp32)",
     "as[t * LDA + s] = (s <= t) ? acc[i][j] : 0.f;",
     "as[t * LDA + s] = (s <= t) ? __bfloat162float(__float2bfloat16_rn(acc[i][j])) : 0.f;",
     True),
]


def run(name, dev):
    causal_dot._lib = None  # load the library built from causal_dot.SOURCE
    chip_smoke.build(causal_dot)
    readings, _ = chip_smoke.compare_causal_dot(causal_dot, dev)
    accepted = all(chip_smoke.agrees(r) for r in readings)
    for r in readings:
        chip_smoke.log(f"  {r['case']}: out max abs {r['out_max_abs']:.3e}, "
                       f"{r['out_over_limit']:.3f} of its limit; S rel {r['s_rel']:.3e}, "
                       f"z rel {r['z_rel']:.3e}")
    chip_smoke.log(f"{name}: {'accepted' if accepted else 'rejected'}")
    return {"name": name, "accepted": accepted, "readings": readings}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_mutants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    chip_smoke.card_info()
    sound_source = causal_dot.SOURCE
    text = sound_source.read_text()
    results = [run("sound", dev)]
    ok = results[0]["accepted"]
    mutant_dir = causal_dot.BUILD_DIR / "mutants"
    mutant_dir.mkdir(parents=True, exist_ok=True)
    for name, breaks, old, new, must_reject in MUTANTS:
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: its text is not once in {sound_source}")
        causal_dot.SOURCE = mutant_dir / f"causal_dot_norm_{name}.cu"
        causal_dot.SOURCE.write_text(text.replace(old, new))
        chip_smoke.log(f"{name} ({breaks}):")
        r = run(name, dev)
        r.update(breaks=breaks, must_reject=must_reject)
        results.append(r)
        ok = ok and not (must_reject and r["accepted"])
    causal_dot.SOURCE, causal_dot._lib = sound_source, None
    chip_smoke.log(json.dumps({
        "limits": {"out_rtol": chip_smoke.OUT_RTOL, "out_atol": chip_smoke.OUT_ATOL,
                   "state_rtol": chip_smoke.STATE_RTOL},
        "kernels": results,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
