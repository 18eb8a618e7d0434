"""Why the wgmma flash kernels split P (and dS) into two bf16 halves.

The TPU kernels (``orion_tpu/ops/pallas/flash_attention.py``) keep P in fp32
for the forward's ``p @ v`` (``_fwd_kernel``), and P and dS in fp32 for the
backward's second products (``ds @ k``, ``p^T @ do``, ``ds^T @ q``;
``_dq_kernel``, ``_dkv_kernel``). A ``wgmma`` takes bf16 operands, so the
card's kernels (the wgmma variants in ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``) run each such product twice, on hi =
bf16(x) and lo = bf16(x - hi), into one fp32 accumulator. This file
emulates that arithmetic in plain torch on the CPU at a small shape (bh 2,
T 256, D 128, window 96, bf16 inputs made with numpy from a seed): bf16
products are exact in fp32, so fp32 matmuls of the bf16 halves give what
the tensor cores sum, up to the order of the sums. The forward runs as the
kernel does, over 64-key tiles with the online softmax in base 2. It holds
the results against ``flash_fwd_plain`` / ``flash_dq_plain`` /
``flash_dkv_plain`` within ``chip_smoke.py``'s limits for the card's kernels
(out: 1e-4 max|ref| + 2^-7 |ref| a element, lse 1e-5 of max(1, |lse|); the
gradients: 1e-5 + 1e-4 max|ref| + 2^-7 |ref|), and shows that P (and dS)
rounded once to bf16 exceed them: out reads about 4x its limit (0.82 with
the split), the gradients 4.8-7x.
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


def _emulate_fwd(q, k, v, split):
    """The wgmma forward's arithmetic: per 64-key tile, S from bf16 operands
    with fp32 sums in base 2 (scale log2 e), masked to -inf; m' = max(m,
    rowmax S), alpha = 2^(m - m'), P = 2^(S - m'), l = alpha l + rowsum P,
    acc = alpha acc + P v on the halves of P; then out = acc / l rounded
    once to bf16 and lse = m ln 2 + log l."""
    sl2 = D ** -0.5 / math.log(2.0)
    rows, cols = torch.arange(T)[:, None], torch.arange(T)[None, :]
    mask = (rows >= cols) & (rows - cols < WINDOW)
    s = torch.where(mask, (q.float() @ k.float().transpose(1, 2)) * sl2, -math.inf)
    m = torch.full((BH, T), -math.inf)
    l, acc = torch.zeros(BH, T), torch.zeros(BH, T, D)
    for j in range(0, T, 64):
        st = s[:, :, j:j + 64]
        m_new = torch.maximum(m, st.amax(-1))
        base = torch.where(m_new == -math.inf, 0.0, m_new)  # a row with no key yet: P = 0
        alpha = torch.exp2(m - base)
        p = torch.exp2(st - base[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + sum(h @ v[:, j:j + 64].float() for h in _halves(p, split))
        m = m_new
    safe = torch.where(l == 0, 1.0, l)
    return (acc / safe[..., None]).bfloat16(), (m * math.log(2.0) + torch.log(safe))[..., None]


@pytest.fixture(scope="module")
def fwd_readings():
    """out's reading against ``flash_fwd_plain`` as a share of the card's
    limit, for the split and for rounding P once; lse's for the split."""
    q, k, v = _inputs()[:3]
    r_out, r_lse = fa.flash_fwd_plain(q, k, v, causal=True, window=WINDOW)
    out = {}
    for split in (True, False):
        got, lse = _emulate_fwd(q, k, v, split)
        out[split] = chip_smoke._grad_reading(
            got, r_out, chip_smoke.FLASH_RTOL[torch.bfloat16], chip_smoke.FLASH_ATOL_OF_MAX
        )["over_limit"]
        if split:
            out["lse"] = float(((lse - r_lse).abs()
                                / (chip_smoke.LSE_RTOL * r_lse.abs().clamp_min(1.0))).max())
    return out


def test_the_forward_split_meets_the_card_limit(fwd_readings):
    assert fwd_readings[True] <= 1.0 and fwd_readings["lse"] <= 1.0, fwd_readings


def test_rounding_p_once_misses_the_forward_card_limit(fwd_readings):
    assert fwd_readings[False] > 1.0, fwd_readings


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
