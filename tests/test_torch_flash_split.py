"""Why the wgmma flash backward splits P and dS into two bf16 halves.

The TPU backward (``orion_tpu/ops/pallas/flash_attention.py``, ``_dq_kernel``
and ``_dkv_kernel``) keeps P and dS in fp32 for its second products
(``ds @ k``, ``p^T @ do``, ``ds^T @ q``). A ``wgmma`` takes bf16 operands, so
the card's kernels (``csrc/flash_attention_bwd.cu``, the wgmma variant) run
each second product twice, on hi = bf16(x) and lo = bf16(x - hi), into one
fp32 accumulator. This file emulates that arithmetic in plain torch on the
CPU at a small shape (bh 2, T 256, D 128, window 96, bf16 inputs made with
numpy from a seed): bf16 products are exact in fp32, so fp32 matmuls of the
bf16 halves give what the tensor cores sum, up to the order of the sums. It
holds the result against ``flash_dq_plain`` / ``flash_dkv_plain`` within
``chip_smoke.py``'s limit for the card's kernels (1e-5 + 1e-4 max|ref| +
2^-7 |ref| a element), and shows that P and dS rounded once to bf16 exceed
that limit.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from orion_tpu_torch.ops.kernels import flash_attention as fa

BH, T, D, WINDOW = 2, 256, 128, 96


def _inputs():
    rng = np.random.default_rng(8)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((BH, T, D), dtype=np.float32))
                  .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_fwd_plain(q, k, v, causal=True, window=WINDOW)
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    return q, k, v, g, lse, delta


def _halves(x, split):
    """x as the wgmma operands the kernel feeds: [hi, lo], or [bf16(x)]."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if split else [hi]


def _emulate(q, k, v, g, lse, delta, split):
    """The wgmma kernels' arithmetic: S and dP from bf16 operands with fp32
    sums, P = exp2(S scale log2 e - lse log2 e) under the mask, dS = P (dP -
    delta) scale, then each second product on the halves of P or dS, summed
    in fp32 and rounded once to bf16."""
    scale, log2e = D ** -0.5, 1.0 / math.log(2.0)
    rows, cols = torch.arange(T)[:, None], torch.arange(T)[None, :]
    mask = (rows >= cols) & (rows - cols < WINDOW)
    s = q.float() @ k.float().transpose(1, 2)
    p = torch.where(mask, torch.exp2(s * (scale * log2e) - lse * log2e), 0.0)
    ds = p * (g.float() @ v.float().transpose(1, 2) - delta) * scale
    dq = sum(h @ k.float() for h in _halves(ds, split))
    dk = sum(h.transpose(1, 2) @ q.float() for h in _halves(ds, split))
    dv = sum(h.transpose(1, 2) @ g.float() for h in _halves(p, split))
    return {"dq": dq.bfloat16(), "dk": dk.bfloat16(), "dv": dv.bfloat16()}


@pytest.fixture(scope="module")
def readings():
    """Each output's reading against the plain passes, as a share of the
    card's limit, for the split and for rounding once."""
    args = _inputs()
    opts = dict(causal=True, window=WINDOW)
    dk, dv = fa.flash_dkv_plain(*args, **opts)
    ref = {"dq": fa.flash_dq_plain(*args, **opts), "dk": dk, "dv": dv}
    rtol = chip_smoke.FLASH_RTOL[torch.bfloat16]
    out = {}
    for split in (True, False):
        got = _emulate(*args, split=split)
        out[split] = {n: chip_smoke._grad_reading(
            got[n], ref[n], rtol, chip_smoke.FLASH_ATOL_OF_MAX, chip_smoke.FLASH_GRAD_FLOOR
        )["over_limit"] for n in ref}
    return out


@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_the_split_meets_the_card_limit(readings, name):
    assert readings[True][name] <= 1.0, readings


@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_rounding_p_and_ds_once_misses_the_card_limit(readings, name):
    assert readings[False][name] > 1.0, readings


def test_two_halves_carry_x_to_about_16_bits():
    """|x - hi - lo| <= 2^-16 |x| for fp32 x of any scale (hi takes 8
    significant bits, lo the next 8, each rounded to nearest)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(1 << 16).astype(np.float32)
                         * np.float32(10.0) ** rng.integers(-6, 6, 1 << 16).astype(np.float32))
    hi, lo = _halves(x, True)
    assert float(((x - hi - lo).abs() / x.abs()).max()) <= 2.0**-16
