"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a card (decided inside the
fixture, never at import). On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: fp32 outputs to 1e-4 relative (sums in another order); bf16
outputs to one bf16 rounding step (2^-7 relative) plus 1e-4 absolute for
elements near zero (the backward's gradients: 1e-4 of their largest
magnitude, where its numerator and denominator parts cancel), the limits of
``chip_smoke.py``; fp32 states, num and den to 1e-4 of their largest
magnitude; the public op's kernels (rows 2, 5) alike, their fp32 dk, dv
and dS0 to 1e-4 relative plus 1e-4 of their largest magnitude (row 5 in
two variants, each case asserting which one's counter moved: wgmma for bf16
at Dk = Dv = 128, its scores and carried R as two bf16 halves, on one chunk
first; simt for the rest), and the op's forward + backward through
``CausalDotProductFn`` against autograd of the plain form within the same
limits. A model's backward through the kernels against
``backend="torch"``: fp32 as the CPU parity tests (loss 1e-5 relative,
gradients 1e-4 relative plus 1e-5 of their largest magnitude); bf16 within
``chip_smoke.py``'s lm_1b3 limits (loss 1e-2, gradients 5e-2 relative L2).
Flash attention (rows 6-8): out, dq, dk, dv as the bf16 / fp32 outputs
above, with the absolute term 1e-4 of the largest magnitude (where dP and
delta cancel in dS) and, for the gradients, a floor of 1e-5: where a
gradient vanishes in exact arithmetic (T = 1: a row's only key gives
dS = P (dP - delta) = 0), the kernel's dP and torch's delta are two fp32 dot
products of unit-scale inputs summed in different orders, about 1e-7 apart
at D 64 (1e-6 at D 128). lse to 1e-5 of max(1, |lse|) (fp32 sums of exp in
another order, through one log). Forward and backward (rows 6, 7, 8) in
both variants, each case asserting which one's counters moved: wgmma for
bf16 at D 128 (its P and dS carried as two bf16 halves, so the same limits
hold), simt for the rest. Row 1 likewise: wgmma for bf16 at Dk 128 with Dv
a multiple of 64 (its scores and state carried as two bf16 halves), simt
for the rest; its layouts held on one chunk and two first. Rows 3 and 4
(the backward's passes) likewise: wgmma for bf16 at a contracted width of
128, simt for the rest, on one chunk and two first, then ragged, T 1, with
a state and with (gsf, gzf). The grouped matmul (rows 9, 10): y and dx
as the bf16 / fp32 outputs above with 1e-4 of the largest magnitude beside
the relative term (a sum over K products in another order); dw, fp32 sums
of exact products in another order, within 1e-4 of each expert's largest
magnitude, and exactly 0 for an expert without tiles. The int4
dequant-matmul (row 14) as the bf16 / fp32 outputs above with 1e-4 of the
largest magnitude beside the relative term; the fused Adafactor passes
(rows 11-13): the sums and the squared sum within 1e-4 relative (positive
fp32 sums in another order), apply bitwise (the same roundings in the same
order), a tiny fp32 model's adafactor_fused steps against the plain
formulas within JAX's own fused-vs-optax tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orion_tpu_torch.models.configs import TINY
from orion_tpu_torch.models.transformer import TransformerLM
from orion_tpu_torch.ops import linear_attention as la
from orion_tpu_torch.ops import softmax_attention as sa
from orion_tpu_torch.ops.kernels import adafactor as af
from orion_tpu_torch.ops.kernels import causal_dot
from orion_tpu_torch.ops.kernels import flash_attention as fa
from orion_tpu_torch.ops.kernels import gmm as gm
from orion_tpu_torch.ops.kernels import q4_matmul as q4m
from orion_tpu_torch.training.trainer import lm_loss

pytestmark = pytest.mark.cuda
FLASH_GRAD_FLOOR = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "dtype,bh,t,dk,dv,state",
    [
        (torch.float32, 3, 70, 32, 24, False),
        (torch.float32, 2, 129, 128, 200, True),
        (torch.bfloat16, 5, 1, 16, 64, True),
        (torch.bfloat16, 4, 333, 128, 128, True),
        (torch.bfloat16, 2, 64, 100, 72, False),
        (torch.bfloat16, 3, 200, 128, 64, True),  # wgmma: a ragged last chunk
        (torch.bfloat16, 2, 1, 128, 192, False),  # wgmma: T 1, three value tiles
        (torch.bfloat16, 2, 130, 128, 96, True),  # simt: Dv not a multiple of 64
    ],
)
def test_causal_dot_norm_matches_plain(dev, dtype, bh, t, dk, dv, state):
    """Row 1 against its plain version, in the variant
    ``causal_dot_norm_variant`` names (wgmma for bf16 at Dk 128 with Dv a
    multiple of 64, simt for the rest); only that variant's counter moves."""
    g = torch.Generator(device=dev).manual_seed(t)
    q = (torch.nn.functional.elu(torch.randn(bh, t, dk, device=dev, generator=g)) + 1).to(dtype)
    k = (torch.nn.functional.elu(torch.randn(bh, t, dk, device=dev, generator=g)) + 1).to(dtype)
    v = torch.randn(bh, t, dv, device=dev, generator=g).to(dtype)
    s0 = z0 = None
    if state:
        s0 = torch.randn(bh, dk, dv, device=dev, generator=g)
        z0 = torch.rand(bh, dk, device=dev, generator=g) * 10
    variant = causal_dot.causal_dot_norm_variant(q, k, v)
    assert variant == ("wgmma" if dtype == torch.bfloat16 and dk == 128 and dv % 64 == 0
                       else "simt")
    before = _norm_counts()
    out, s, z = causal_dot.causal_dot_norm_cuda(q, k, v, s0, z0)
    assert _norm_counts() == tuple(
        n + d for n, d in zip(before, (1, variant == "wgmma", variant == "simt")))
    r_out, r_s, r_z = causal_dot.causal_dot_norm_plain(q, k, v, s0, z0)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), r_out.float(), rtol=2**-7, atol=1e-4)
    else:
        torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)
    for got, ref in ((s, r_s), (z, r_z)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def _norm_counts():
    return causal_dot.launches, causal_dot.launches_wgmma, causal_dot.launches_simt


@pytest.mark.parametrize("kind", ["scores", "state", "two chunks"])
def test_causal_dot_norm_wgmma_layouts_on_one_chunk(dev, kind):
    """The wgmma forward's operand layouts, one head at Dk 128, Dv 64:
    "scores" (T 64, no state: A = q k^T K-major, A's halves as the register
    A operand against v MN-major, the mask, and S = k^T v with k^T read
    MN-major), "state" (T 64 from S0: q against S's halves written MN-major
    from the registers), "two chunks" (T 128: the second chunk reads the
    state the first one wrote). Within chip_smoke.py's limits: out one bf16
    step plus 1e-4, S and z 1e-4 of their largest magnitude."""
    g = torch.Generator(device=dev).manual_seed(11)
    t = 128 if kind == "two chunks" else 64
    phi = lambda x: (torch.nn.functional.elu(x) + 1).bfloat16()  # noqa: E731
    q, k = (phi(torch.randn(1, t, 128, device=dev, generator=g)) for _ in range(2))
    v = torch.randn(1, t, 64, device=dev, generator=g).bfloat16()
    s0 = z0 = None
    if kind == "state":
        s0 = torch.randn(1, 128, 64, device=dev, generator=g)
        z0 = torch.rand(1, 128, device=dev, generator=g) * 10
    assert causal_dot.causal_dot_norm_variant(q, k, v) == "wgmma"
    out, s, z = causal_dot.causal_dot_norm_cuda(q, k, v, s0, z0)
    r_out, r_s, r_z = causal_dot.causal_dot_norm_plain(q, k, v, s0, z0)
    torch.testing.assert_close(out.float(), r_out.float(), rtol=2**-7, atol=1e-4)
    for got, ref in ((s, r_s), (z, r_z)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def test_linear_attention_auto_uses_the_kernel(dev):
    q = torch.rand(2, 3, 50, 32, device=dev)
    before = causal_dot.launches
    out, (s, z) = la.linear_attention(q, q, q, return_state=True)
    assert causal_dot.launches == before + 1
    ref, (rs, rz) = la.linear_attention(q, q, q, return_state=True, backend="torch")
    assert causal_dot.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, rs, rtol=1e-4, atol=1e-3)


def test_kernel_rejects_what_it_does_not_take(dev):
    q = torch.rand(2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        causal_dot.causal_dot_norm_cuda(q.transpose(0, 1).contiguous().transpose(0, 1), q, q)
    with pytest.raises(TypeError):
        causal_dot.causal_dot_norm_cuda(q.half(), q.half(), q.half())
    big = torch.rand(1, 4, 256, device=dev)
    with pytest.raises(ValueError, match="Dk"):
        causal_dot.causal_dot_norm_cuda(big, big, big)


def _max_close(got, ref, rtol, floor=0.0):
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=floor + 1e-4 * float(ref.float().abs().max()))


def _bwd_case(dev, dtype, bh, t, dk, dv, state, seed):
    """One layer's backward inputs: q, k phi-mapped, v, and g, gden from the
    plain forward's num and den through the quotient rule; with ``state`` an
    initial state and cotangents (gsf, gzf) of the final one."""
    g = torch.Generator(device=dev).manual_seed(seed)
    phi = lambda x: (torch.nn.functional.elu(x) + 1).to(dtype)  # noqa: E731
    q = phi(torch.randn(bh, t, dk, device=dev, generator=g))
    k = phi(torch.randn(bh, t, dk, device=dev, generator=g))
    v = torch.randn(bh, t, dv, device=dev, generator=g).to(dtype)
    gout = torch.randn(bh, t, dv, device=dev, generator=g).to(dtype)
    s0 = z0 = gsf = gzf = None
    if state:
        s0 = torch.randn(bh, dk, dv, device=dev, generator=g)
        z0 = torch.rand(bh, dk, device=dev, generator=g) * 10
        gsf = 0.05 * torch.randn(bh, dk, dv, device=dev, generator=g)
        gzf = 0.05 * torch.randn(bh, dk, device=dev, generator=g)
    _, _, _, r_num, r_den = causal_dot.causal_dot_norm_plain(q, k, v, s0, z0, with_parts=True)
    gnum, gden = causal_dot.quotient_rule(gout, r_num, r_den, 1e-6, dtype)
    return q, k, v, gnum, gden, s0, z0, gsf, gzf, (r_num, r_den)


def _bwd_counts():
    return (causal_dot.launches_dq, causal_dot.launches_dq_wgmma, causal_dot.launches_dq_simt,
            causal_dot.launches_rev, causal_dot.launches_rev_wgmma, causal_dot.launches_rev_simt)


def _check_bwd(q, k, v, gnum, gden, s0, z0, gsf, gzf):
    """Rows 3 and 4 against their plain versions, each in the variant its
    chooser names; only that variant's counter moves."""
    dq_variant = causal_dot.causal_dot_dq_den_variant(gnum, v, k)
    rev_variant = causal_dot.causal_dot_rev_variant(q, k, v, gnum)
    before = _bwd_counts()
    got = (causal_dot.causal_dot_dq_den_cuda(gnum, v, k, gden, s0, z0),
           *causal_dot.causal_dot_rev_den_cuda(q, k, v, gnum, gden, gsf, gzf))
    moved = (1, dq_variant == "wgmma", dq_variant == "simt",
             1, rev_variant == "wgmma", rev_variant == "simt")
    assert _bwd_counts() == tuple(n + d for n, d in zip(before, moved))
    ref = (causal_dot.causal_dot_dq_den_plain(gnum, v, k, gden, s0, z0),
           *causal_dot.causal_dot_rev_den_plain(q, k, v, gnum, gden, gsf, gzf))
    for x, r in zip(got[:3], ref[:3]):
        assert x.dtype == q.dtype and x.shape == r.shape
        _max_close(x, r, 2**-7 if q.dtype == torch.bfloat16 else 1e-4)
    for x, r in zip(got[3:], ref[3:]):
        assert x.dtype == torch.float32
        _max_close(x, r, 1e-4)
    return dq_variant, rev_variant


@pytest.mark.parametrize(
    "dtype,bh,t,dk,dv,state",
    [
        (torch.float32, 3, 70, 32, 24, False),
        (torch.float32, 2, 129, 128, 100, True),
        (torch.bfloat16, 5, 1, 16, 64, True),
        (torch.bfloat16, 4, 333, 128, 128, True),  # wgmma: ragged, state and (gsf, gzf)
        (torch.bfloat16, 2, 64, 100, 72, False),
        (torch.bfloat16, 3, 1000, 128, 128, False),  # wgmma: ragged, the reverse walk's first chunk
        (torch.bfloat16, 2, 1, 128, 128, True),  # wgmma: T 1
        (torch.bfloat16, 2, 130, 64, 128, True),  # dq wgmma at Dk 64 (one tile), the reverse simt
        (torch.bfloat16, 2, 130, 128, 96, True),  # simt: Dv 96
    ],
)
def test_backward_kernels_match_plain(dev, dtype, bh, t, dk, dv, state):
    """Rows 3 and 4 against their plain versions (after row 1's num and den
    against theirs), each in the variant its chooser names: wgmma for bf16
    at a contracted width of 128, simt for the rest."""
    q, k, v, gnum, gden, s0, z0, gsf, gzf, (r_num, r_den) = _bwd_case(
        dev, dtype, bh, t, dk, dv, state, t + 1)
    _, _, _, num, den = causal_dot.causal_dot_norm_cuda(q, k, v, s0, z0, with_parts=True)
    _max_close(num, r_num, 1e-4)
    _max_close(den, r_den, 1e-4)
    variants = _check_bwd(q, k, v, gnum, gden, s0, z0, gsf, gzf)
    bf16_128 = dtype == torch.bfloat16 and dv == 128
    assert variants == ("wgmma" if bf16_128 and dk % 64 == 0 else "simt",
                        "wgmma" if bf16_128 and dk == 128 else "simt")


@pytest.mark.parametrize("kind", ["one chunk", "state", "two chunks", "dq at Dk 64"])
def test_backward_wgmma_layouts_on_one_chunk(dev, kind):
    """The wgmma backward's operand layouts, one head at D 128: "one chunk"
    (T 64, no state: A = x y^T K-major, gden folded in, the masks, A's halves
    against w MN-major, St = y^T w with y^T read MN-major), "state" (T 64
    from S0 and (gsf, gzf): St's seeds read transposed (dq, dk) and as laid
    out (dv), x against St's halves), "two chunks" (T 128: each walk's second
    chunk reads the state its first wrote; dk and dv walk the later chunk
    first), "dq at Dk 64" (T 64, one output tile). Within chip_smoke.py's
    limits, as ``test_backward_kernels_match_plain``."""
    t = 128 if kind == "two chunks" else 64
    dk = 64 if kind == "dq at Dk 64" else 128
    case = _bwd_case(dev, torch.bfloat16, 1, t, dk, 128, kind == "state", 11)
    assert _check_bwd(*case[:9]) == ("wgmma", "simt" if dk == 64 else "wgmma")


@pytest.mark.parametrize(
    "dtype,bh,t,dk,dv,state",
    [
        (torch.float32, 3, 70, 32, 24, False),
        (torch.float32, 2, 129, 128, 100, True),
        (torch.bfloat16, 5, 1, 16, 64, True),
        (torch.bfloat16, 4, 333, 128, 128, True),  # wgmma from here on, but the last two
        (torch.bfloat16, 4, 1, 128, 128, False),  # T 1
        (torch.bfloat16, 2, 1, 128, 64, True),  # T 1 from S0
        (torch.bfloat16, 3, 1000, 128, 128, True),  # a ragged last chunk, S0 and dSf
        (torch.bfloat16, 3, 1000, 128, 128, False),  # neither
        (torch.bfloat16, 2, 200, 128, 64, True),  # Dv 64: one value tile
        (torch.bfloat16, 2, 65, 128, 128, False),  # a last chunk of one token
        (torch.bfloat16, 2, 64, 100, 72, False),  # simt: Dk 100
        (torch.bfloat16, 2, 130, 128, 96, True),  # simt: Dv not a multiple of 64
    ],
)
def test_raw_kernels_match_plain(dev, dtype, bh, t, dk, dv, state):
    """Rows 2 and 5 (the public op's forward and reverse pass) against their
    plain versions; ``state`` gives both an S0 and a dSf seed. Row 2 in the
    variant ``causal_dot_raw_variant`` names (wgmma for bf16 at Dk 128 with
    Dv a multiple of 64, simt for the rest), row 5 in the one
    ``causal_dot_rev_variant`` names (wgmma for bf16 at Dk = Dv = 128, simt
    for the rest): only their counters move."""
    g = torch.Generator(device=dev).manual_seed(t + 2)
    phi = lambda x: (torch.nn.functional.elu(x) + 1).to(dtype)  # noqa: E731
    q = phi(torch.randn(bh, t, dk, device=dev, generator=g))
    k = phi(torch.randn(bh, t, dk, device=dev, generator=g))
    v = torch.randn(bh, t, dv, device=dev, generator=g).to(dtype)
    gout = torch.randn(bh, t, dv, device=dev, generator=g).to(dtype)
    s0 = gsf = None
    if state:
        s0 = torch.randn(bh, dk, dv, device=dev, generator=g)
        gsf = torch.randn(bh, dk, dv, device=dev, generator=g)
    variant = causal_dot.causal_dot_raw_variant(q, k, v)
    assert variant == ("wgmma" if dtype == torch.bfloat16 and dk == 128 and dv % 64 == 0
                       else "simt")
    rev = causal_dot.causal_dot_rev_variant(q, k, v, gout)
    assert rev == ("wgmma" if dtype == torch.bfloat16 and dk == dv == 128 else "simt")
    before = _raw_counts()
    out, sf = causal_dot.causal_dot_cuda(q, k, v, s0)
    dk_, dv_, ds0 = causal_dot.causal_dot_rev_cuda(q, k, v, gout, gsf)
    assert _raw_counts() == tuple(n + d for n, d in zip(before, (
        1, variant == "wgmma", variant == "simt", 1, rev == "wgmma", rev == "simt")))
    r_out, r_sf = causal_dot.causal_dot_plain(q, k, v, s0)
    assert out.dtype == dtype and out.shape == r_out.shape
    _max_close(out, r_out, 2**-7 if dtype == torch.bfloat16 else 1e-4)
    _max_close(sf, r_sf, 1e-4)
    for x, r in zip((dk_, dv_, ds0), causal_dot.causal_dot_rev_plain(q, k, v, gout, gsf)):
        assert x.dtype == torch.float32 and x.shape == r.shape
        _max_close(x, r, 1e-4)


def _raw_counts():
    return (causal_dot.launches_raw, causal_dot.launches_raw_wgmma, causal_dot.launches_raw_simt,
            causal_dot.launches_raw_rev, causal_dot.launches_raw_rev_wgmma,
            causal_dot.launches_raw_rev_simt)


@pytest.mark.parametrize("kind", ["one chunk", "state", "two chunks", "no state out"])
def test_causal_dot_raw_wgmma_on_one_chunk(dev, kind):
    """Row 2's wgmma kernel, one head at Dk 128, Dv 64: one chunk (the
    scores' mask and halves, S = k^T v), from S0 (q against S's halves),
    two chunks (the second reads the state the first wrote), and without
    the state out (the dq pass's call: out alone, S_T not written). out one
    bf16 step plus 1e-4 of its largest magnitude (chip_smoke.py's RAW
    limits: an element where the sum cancels is held by the second term), S
    1e-4 of its largest magnitude."""
    g = torch.Generator(device=dev).manual_seed(13)
    t = 128 if kind == "two chunks" else 64
    phi = lambda x: (torch.nn.functional.elu(x) + 1).bfloat16()  # noqa: E731
    q, k = (phi(torch.randn(1, t, 128, device=dev, generator=g)) for _ in range(2))
    v = torch.randn(1, t, 64, device=dev, generator=g).bfloat16()
    s0 = torch.randn(1, 128, 64, device=dev, generator=g) if kind == "state" else None
    before = _raw_counts()
    out, sf = causal_dot.causal_dot_cuda(q, k, v, s0, with_state=kind != "no state out")
    assert _raw_counts() == tuple(n + d for n, d in zip(before, (1, 1, 0, 0, 0, 0)))
    r_out, r_sf = causal_dot.causal_dot_plain(q, k, v, s0)
    _max_close(out, r_out, 2**-7)
    if kind == "no state out":
        assert sf is None
    else:
        torch.testing.assert_close(sf, r_sf, rtol=0, atol=1e-4 * float(r_sf.abs().max()))


@pytest.mark.parametrize("kind", ["one chunk", "dSf", "two chunks", "ragged"])
def test_causal_dot_rev_wgmma_on_one_chunk(dev, kind):
    """Row 5's wgmma kernel, one head at Dk = Dv = 128: one chunk (the
    scores' anti-causal mask and halves against w, the fp32 pairs stored),
    from dSf (R's seed read transposed by dk, as laid out by dv, x against
    its halves, dS0 from the dv blocks' registers), two chunks (the later
    walked first; the earlier reads the R it left), and T 100 (the first
    chunk walked is the ragged one, TMA's zero fill its only mask). dk, dv
    within 1e-4 relative plus 1e-4 of their largest magnitude
    (chip_smoke.py's RAW limits for fp32), dS0 1e-4 of its largest."""
    g = torch.Generator(device=dev).manual_seed(19)
    t = {"two chunks": 128, "ragged": 100}.get(kind, 64)
    phi = lambda x: (torch.nn.functional.elu(x) + 1).bfloat16()  # noqa: E731
    q, k = (phi(torch.randn(1, t, 128, device=dev, generator=g)) for _ in range(2))
    v, gout = (torch.randn(1, t, 128, device=dev, generator=g).bfloat16() for _ in range(2))
    gsf = 8 * torch.randn(1, 128, 128, device=dev, generator=g) if kind != "one chunk" else None
    before = _raw_counts()
    dk_, dv_, ds0 = causal_dot.causal_dot_rev_cuda(q, k, v, gout, gsf)
    assert _raw_counts() == tuple(n + d for n, d in zip(before, (0, 0, 0, 1, 1, 0)))
    r_dk, r_dv, r_ds0 = causal_dot.causal_dot_rev_plain(q, k, v, gout, gsf)
    _max_close(dk_, r_dk, 1e-4)
    _max_close(dv_, r_dv, 1e-4)
    torch.testing.assert_close(ds0, r_ds0, rtol=0, atol=1e-4 * float(r_ds0.abs().max()))


@pytest.mark.parametrize("dk,dv,want", [(128, 128, (2, 0, 1, 0)), (128, 64, (1, 1, 0, 1))])
def test_causal_dot_product_fn_on_the_wgmma_route(dev, dk, dv, want):
    """The public op's forward + backward at Dk 128 in bf16: the forward on
    the wgmma kernel; the dq pass, on (g, v, k), on the wgmma kernel at Dv
    128 and on the simt one at Dv 64 (its contracted width); the reverse pass
    once, on its wgmma kernel at Dv 128 and on the simt one at Dv 64. Against
    the plain form differentiated by autograd, within one bf16 step plus
    1e-4 of the largest magnitude (fp32 outputs 1e-4)."""
    from orion_tpu_torch.ops import causal_dot_product

    g = torch.Generator(device=dev).manual_seed(17)
    phi = lambda x: (torch.nn.functional.elu(x) + 1).bfloat16()  # noqa: E731
    q0, k0 = (phi(torch.randn(2, 2, 300, dk, device=dev, generator=g)) for _ in range(2))
    v0 = torch.randn(2, 2, 300, dv, device=dev, generator=g).bfloat16()
    s00 = torch.randn(2, 2, dk, dv, device=dev, generator=g)
    gout = torch.randn(2, 2, 300, dv, device=dev, generator=g).bfloat16()
    gsf = torch.randn(2, 2, dk, dv, device=dev, generator=g)
    res = {}
    for backend in ("cuda", "torch"):
        q, k, v, s0 = (x.clone().requires_grad_() for x in (q0, k0, v0, s00))
        before = _raw_counts()
        out, sf = causal_dot_product(q, k, v, backend=backend, return_state=True,
                                     initial_state=s0)
        ((out.float() * gout.float()).sum() + (sf * gsf).sum()).backward()
        moved = tuple(a - b for a, b in zip(_raw_counts(), before))
        assert moved == ((2, *want[:2], 1, *want[2:]) if backend == "cuda" else (0,) * 6)
        res[backend] = [x.detach() for x in (out, sf, q.grad, k.grad, v.grad, s0.grad)]
    for x, ref in zip(res["cuda"], res["torch"]):
        _max_close(x, ref, 2**-7 if x.dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state,return_state", [(True, True), (False, False)])
def test_causal_dot_product_fn_matches_autograd_of_plain(dev, dtype, with_state, return_state):
    """The public op's forward + backward through ``CausalDotProductFn``
    against the plain chunked form differentiated by autograd: out and S as
    above, the gradients within one step of their dtype plus 1e-4 of their
    largest magnitude; the forward kernel twice, the reverse pass once."""
    from orion_tpu_torch.ops import causal_dot_product

    g = torch.Generator(device=dev).manual_seed(11)
    phi = lambda x: (torch.nn.functional.elu(x) + 1).to(dtype)  # noqa: E731
    q0 = phi(torch.randn(2, 3, 200, 64, device=dev, generator=g))
    k0 = phi(torch.randn(2, 3, 200, 64, device=dev, generator=g))
    v0 = torch.randn(2, 3, 200, 96, device=dev, generator=g).to(dtype)
    s00 = torch.randn(2, 3, 64, 96, device=dev, generator=g)
    gout = torch.randn(2, 3, 200, 96, device=dev, generator=g).to(dtype)
    gsf = torch.randn(2, 3, 64, 96, device=dev, generator=g)
    res = {}
    for backend in ("cuda", "torch"):
        q, k, v, s0 = (x.clone().requires_grad_() for x in (q0, k0, v0, s00))
        before = (causal_dot.launches_raw, causal_dot.launches_raw_rev)
        r = causal_dot_product(q, k, v, backend=backend, return_state=return_state,
                               initial_state=s0 if with_state else None)
        out = r[0] if return_state else r
        loss = (out.float() * gout.float()).sum()
        if return_state:
            loss = loss + (r[1] * gsf).sum()
        loss.backward()
        launched = (causal_dot.launches_raw - before[0], causal_dot.launches_raw_rev - before[1])
        assert launched == ((2, 1) if backend == "cuda" else (0, 0))
        res[backend] = [x.detach() for x in (out, *(r[1:] if return_state else []), q.grad,
                                             k.grad, v.grad, *([s0.grad] if with_state else []))]
    rtol = 2**-7 if dtype == torch.bfloat16 else 1e-4
    for x, ref in zip(res["cuda"], res["torch"]):
        assert x.dtype == ref.dtype and x.shape == ref.shape
        _max_close(x, ref, rtol if x.dtype == dtype else 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_backward_through_the_kernels_matches_torch(dev, dtype):
    cfg = dataclasses.replace(TINY, dtype=dtype, n_layers=3, remat=True, remat_skip=1)
    batch = torch.randint(0, cfg.vocab_size, (2, 200), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    results = {}
    for backend in ("cuda", "torch"):
        model = TransformerLM(dataclasses.replace(cfg, backend=backend), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(1))
        before = (causal_dot.launches, causal_dot.launches_dq, causal_dot.launches_rev)
        loss = lm_loss(model, batch)
        loss.backward()
        counts = tuple(a - b for a, b in zip(
            (causal_dot.launches, causal_dot.launches_dq, causal_dot.launches_rev), before))
        results[backend] = (float(loss), {n: p.grad for n, p in model.named_parameters()}, counts)
    assert results["cuda"][2] == (3 + 2, 3, 3)  # the forward again for the 2 rematted blocks
    assert results["torch"][2] == (0, 0, 0)
    (loss_k, grads_k, _), (loss_t, grads_t, _) = results["cuda"], results["torch"]
    for n, ref in grads_t.items():
        assert grads_k[n] is not None, n
        if dtype == "float32":
            torch.testing.assert_close(grads_k[n], ref, rtol=1e-4,
                                       atol=1e-5 * float(ref.abs().max()))
        else:
            assert float((grads_k[n] - ref).norm() / ref.norm()) <= 5e-2, n
    assert abs(loss_k - loss_t) <= (1e-5 * abs(loss_t) if dtype == "float32" else 1e-2)


@pytest.mark.parametrize(
    "dtype,bh,tq,tk,d,causal,window",
    [
        (torch.float32, 3, 70, 70, 32, True, None),
        (torch.float32, 2, 129, 129, 128, True, 40),
        (torch.float32, 2, 50, 90, 64, True, 8),  # more keys than queries
        (torch.bfloat16, 5, 1, 1, 64, True, 16),
        (torch.bfloat16, 4, 333, 333, 128, True, 100),
        (torch.bfloat16, 2, 200, 200, 128, False, None),  # bidirectional
        (torch.bfloat16, 2, 100, 100, 32, True, 1024),  # the band covers everything
        (torch.bfloat16, 2, 96, 96, 64, False, 20),  # a bidirectional band
        (torch.bfloat16, 3, 150, 290, 128, True, 100),  # wgmma: more keys than queries
        (torch.bfloat16, 2, 290, 150, 128, False, 70),  # wgmma: more queries than keys
        (torch.bfloat16, 3, 1, 1, 128, True, 16),  # wgmma: T 1
    ],
)
def test_flash_kernels_match_plain(dev, dtype, bh, tq, tk, d, causal, window):
    """Rows 6-8 against their plain versions; the backward passes take the
    variant ``flash_bwd_variant`` names (wgmma for bf16 at D 128, simt for
    the rest), and only that variant's counters move."""
    g = torch.Generator(device=dev).manual_seed(tq + d)
    q = torch.randn(bh, tq, d, device=dev, generator=g).to(dtype)
    k = torch.randn(bh, tk, d, device=dev, generator=g).to(dtype)
    v = torch.randn(bh, tk, d, device=dev, generator=g).to(dtype)
    gout = torch.randn(bh, tq, d, device=dev, generator=g).to(dtype)
    opts = dict(causal=causal, window=window)
    variant = fa.flash_bwd_variant(q, k, v, gout)
    assert variant == ("wgmma" if dtype == torch.bfloat16 and d == 128 else "simt")
    assert fa.flash_fwd_variant(q, k, v) == variant
    before = _flash_counts()
    out, lse = fa.flash_fwd_cuda(q, k, v, **opts)
    r_out, r_lse = fa.flash_fwd_plain(q, k, v, **opts)
    delta = (gout.float() * r_out.float()).sum(-1, keepdim=True)
    got = (fa.flash_dq_cuda(q, k, v, gout, r_lse, delta, **opts),
           *fa.flash_dkv_cuda(q, k, v, gout, r_lse, delta, **opts))
    torch.cuda.synchronize()
    moved = {n: a - b for (n, a), b in zip(_flash_counts().items(), before.values())}
    assert moved == {"fwd": 1, "dq": 1, "dkv": 1, f"fwd_{variant}": 1, f"dq_{variant}": 1,
                     f"dkv_{variant}": 1,
                     **{f"{p}_{v}": 0 for p in ("fwd", "dq", "dkv") for v in ("wgmma", "simt")
                        if v != variant}}
    ref = (fa.flash_dq_plain(q, k, v, gout, r_lse, delta, **opts),
           *fa.flash_dkv_plain(q, k, v, gout, r_lse, delta, **opts))
    rtol = 2**-7 if dtype == torch.bfloat16 else 1e-4
    assert out.dtype == dtype and lse.shape == (bh, tq, 1)
    _max_close(out, r_out, rtol)
    torch.testing.assert_close(lse, r_lse, rtol=1e-5, atol=1e-5)
    for x, r in zip(got, ref):
        assert x.dtype == dtype and x.shape == r.shape
        _max_close(x, r, rtol, floor=FLASH_GRAD_FLOOR)


def _flash_counts():
    return {"fwd": fa.launches_fwd, "dq": fa.launches_dq, "dkv": fa.launches_dkv,
            "fwd_wgmma": fa.launches_fwd_wgmma, "fwd_simt": fa.launches_fwd_simt,
            "dq_wgmma": fa.launches_dq_wgmma, "dq_simt": fa.launches_dq_simt,
            "dkv_wgmma": fa.launches_dkv_wgmma, "dkv_simt": fa.launches_dkv_simt}


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_wgmma_layout_on_one_tile(dev, causal):
    """The wgmma forward on one 64 x 64 tile (one head, T 64, D 128): S = q
    k^T K-major, P's halves as the register A operand against v MN-major,
    the online softmax over one tile; bidirectional (no mask) and causal
    (the diagonal tile's mask). out within one bf16 step plus 1e-4 of the
    largest magnitude, lse within 1e-5 (``chip_smoke.py``'s limits)."""
    g = torch.Generator(device=dev).manual_seed(32 + causal)
    q, k, v = (torch.randn(1, 64, 128, device=dev, generator=g).bfloat16() for _ in range(3))
    assert fa.flash_fwd_variant(q, k, v) == "wgmma"
    before = fa.launches_fwd_wgmma
    out, lse = fa.flash_fwd_cuda(q, k, v, causal=causal, window=None)
    assert fa.launches_fwd_wgmma == before + 1
    r_out, r_lse = fa.flash_fwd_plain(q, k, v, causal=causal, window=None)
    _max_close(out, r_out, 2**-7)
    torch.testing.assert_close(lse, r_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["dq", "dk", "dv"])
def test_flash_bwd_wgmma_layouts_on_one_tile(dev, kind, causal):
    """Each MN-major B layout of the wgmma backward, and the conversion of an
    accumulator into wgmma's register A operand, on one 64 x 64 tile (one
    head, T 64): dq (dS from registers, k MN-major), dk (dS^T, q MN-major),
    dv (P^T, g MN-major); bidirectional (no mask) and causal (the diagonal
    tile's mask). Within one bf16 step of the plain version plus 1e-4 of the
    largest magnitude, floor 1e-5 (``chip_smoke.py``'s limits)."""
    g = torch.Generator(device=dev).manual_seed(64 + causal)
    q, k, v, gout = (torch.randn(1, 64, 128, device=dev, generator=g).bfloat16()
                     for _ in range(4))
    assert fa.flash_bwd_variant(q, k, v, gout) == "wgmma"
    opts = dict(causal=causal, window=None)
    r_out, lse = fa.flash_fwd_plain(q, k, v, **opts)
    delta = (gout.float() * r_out.float()).sum(-1, keepdim=True)
    args = (q, k, v, gout, lse, delta)
    if kind == "dq":
        got, ref = fa.flash_dq_cuda(*args, **opts), fa.flash_dq_plain(*args, **opts)
    else:
        i = int(kind == "dv")
        got, ref = fa.flash_dkv_cuda(*args, **opts)[i], fa.flash_dkv_plain(*args, **opts)[i]
    _max_close(got, ref, 2**-7, floor=FLASH_GRAD_FLOOR)


def test_flash_fn_through_softmax_attention_matches_torch(dev):
    """The model's path: softmax_attention on CUDA tensors with grad runs
    FlashAttentionFn (one launch of each kernel) and agrees with autograd
    through the plain form."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(2, 4, 150, 64, device=dev, generator=g).requires_grad_()
               for _ in range(3))
    w = torch.randn(2, 4, 150, 64, device=dev, generator=g)
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    out = sa.softmax_attention(q, k, v, window=33)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == tuple(n + 1 for n in before)
    out_r = sa.softmax_attention(q, k, v, window=33, backend="torch")
    grads_r = torch.autograd.grad((out_r * w).sum(), (q, k, v))
    _max_close(out, out_r, 1e-4)
    for x, r in zip(grads, grads_r):
        _max_close(x, r, 1e-4)


def test_flash_fn_on_the_wgmma_route_matches_the_plain_passes(dev):
    """The model's bf16 path at D 128: softmax_attention with grad runs
    FlashAttentionFn, whose backward takes the wgmma kernels (one launch of
    each, none of the simt ones). Its gradients agree with the plain passes
    fed the same forward's out and lse and delta = rowsum(g . out), within
    one bf16 step plus 1e-4 of the largest magnitude, floor 1e-5."""
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(2, 4, 300, 128, device=dev, generator=g).bfloat16().requires_grad_()
               for _ in range(3))
    gout = torch.randn(2, 4, 300, 128, device=dev, generator=g).bfloat16()
    before = _flash_counts()
    out = sa.softmax_attention(q, k, v, window=100)
    grads = torch.autograd.grad(out, (q, k, v), gout)
    torch.cuda.synchronize()
    moved = {n: a - b for (n, a), b in zip(_flash_counts().items(), before.values())}
    assert moved == {"fwd": 1, "dq": 1, "dkv": 1, "fwd_wgmma": 1, "fwd_simt": 0, "dq_wgmma": 1,
                     "dq_simt": 0, "dkv_wgmma": 1, "dkv_simt": 0}
    flat = [x.detach().reshape(8, 300, 128) for x in (q, k, v, gout)]
    opts = dict(causal=True, window=100)
    with torch.no_grad():
        out2, lse = fa.flash_fwd_cuda(*flat[:3], **opts)
    assert torch.equal(out2, out.detach().reshape(8, 300, 128))
    delta = (flat[3].float() * out2.float()).sum(-1, keepdim=True)
    ref = (fa.flash_dq_plain(*flat, lse, delta, **opts),
           *fa.flash_dkv_plain(*flat, lse, delta, **opts))
    for x, r in zip(grads, ref):
        assert x.dtype == torch.bfloat16
        _max_close(x.reshape(8, 300, 128), r, 2**-7, floor=FLASH_GRAD_FLOOR)


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q = torch.rand(2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd_cuda(q.transpose(0, 1).contiguous().transpose(0, 1), q, q)
    with pytest.raises(TypeError):
        fa.flash_fwd_cuda(q.half(), q.half(), q.half())
    big = torch.rand(1, 4, 256, device=dev)
    with pytest.raises(ValueError, match="D 256"):
        fa.flash_fwd_cuda(big, big, big)


def _gmm_problem(g, dev, dtype, counts, d, tm=128):
    """Rows of x scattered into tile-aligned expert segments, as the dropless
    layer scatters them: ``counts`` real rows per expert, zero padding rows,
    the tile table on the device."""
    counts_t = torch.tensor(counts, dtype=torch.int32, device=dev)
    seg, starts = gm.pad_group_sizes(counts_t, tm)
    m = sum(counts)
    m2 = -(-(m + len(counts) * tm) // tm) * tm
    real = torch.cat([torch.arange(c, device=dev) + int(s) for c, s in zip(counts, starts)])
    x = torch.zeros(m2, d, device=dev)
    x[real] = torch.randn(m, d, device=dev, generator=g)
    return x.to(dtype), real, gm.tile_expert_table(seg, m2 // tm, tm)


@pytest.mark.parametrize(
    "dtype,counts,d,h",
    [
        (torch.bfloat16, (300, 0, 517, 64), 256, 384),  # an expert without rows
        (torch.bfloat16, (100, 37, 0, 250), 96, 200),  # N and K past the 128 / 32 tiles
        # wgmma: K, N past its 64 / 256 tiles (TMA's zero fill), an expert without rows
        (torch.bfloat16, (130, 0, 77, 300), 200, 328),
        (torch.bfloat16, (129, 1, 255, 7), 100, 72),
        (torch.float32, (40, 0, 90, 3), 32, 48),
    ],
)
def test_gmm_kernels_match_plain(dev, dtype, counts, d, h):
    """Row 9 (forward, and dx against w^T) and row 10 (dw) against their plain
    versions: y, dx as one bf16 step (fp32: 1e-4 relative) plus 1e-4 of the
    largest magnitude; dw (fp32 sums of exact products in another order)
    within 1e-4 of each expert's largest magnitude, and exactly 0 for an
    expert without tiles even where the output's memory held NaN."""
    g = torch.Generator(device=dev).manual_seed(d + h)
    e = len(counts)
    x, real, te = _gmm_problem(g, dev, dtype, counts, d)
    w = (torch.randn(e, d, h, device=dev, generator=g) / d**0.5).to(dtype)
    gy = torch.zeros(x.shape[0], h, device=dev)
    gy[real] = torch.randn(len(real), h, device=dev, generator=g)
    gy = gy.to(dtype)
    before = (gm.launches_fwd, gm.launches_dw)
    y = gm.gmm_cuda(x, w, te)
    dx = gm.gmm_cuda(gy, w, te, transpose_w=True)
    junk = torch.full((e * d * h,), float("nan"), device=dev)
    del junk  # the allocator hands this block to dw: an unwritten element shows
    dw = gm.gmm_dw_cuda(x, gy, te, e)
    assert (gm.launches_fwd, gm.launches_dw) == (before[0] + 2, before[1] + 1)
    rtol = 2**-7 if dtype == torch.bfloat16 else 1e-4
    for got, ref in ((y, gm.gmm_torch(x, w, te)), (dx, gm.gmm_torch(gy, w, te, transpose_w=True))):
        assert got.dtype == dtype and got.shape == ref.shape
        _max_close(got, ref, rtol)
    ref_dw = gm.gmm_dw_torch(x, gy, te, e)
    assert dw.dtype == torch.float32 and dw.shape == (e, d, h)
    for i, c in enumerate(counts):
        if int((te == i).sum()) == 0:
            assert bool((dw[i] == 0).all()), i
        else:
            torch.testing.assert_close(dw[i], ref_dw[i], rtol=0,
                                       atol=1e-4 * float(ref_dw[i].abs().max()))


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("kind", ["y", "dx", "dw"])
def test_gmm_wgmma_layouts_on_one_tile(dev, kind, steps):
    """Each of the wgmma kernels' three shared-memory layouts on one 128 x
    256 output tile of one expert: y (B = w[e] [K, N], N-major), dx (B =
    w[e] [N, K], K-major) at one and two 64-deep steps, and dw (A = x^T,
    M-major) over one and two row tiles. Within one bf16 step of the plain
    version plus 1e-4 of the largest magnitude; dw within 1e-4 of it."""
    g = torch.Generator(device=dev).manual_seed(steps)
    rows = 128 * (steps if kind == "dw" else 1)
    k = 64 * steps if kind != "dw" else 128
    te = torch.zeros(rows // 128, dtype=torch.int32, device=dev)
    x = torch.randn(rows, k, device=dev, generator=g).bfloat16()
    if kind == "dw":
        gy = torch.randn(rows, 256, device=dev, generator=g).bfloat16()
        assert gm.gmm_dw_variant(x, gy) == "wgmma"
        got, ref = gm.gmm_dw_cuda(x, gy, te, 1), gm.gmm_dw_torch(x, gy, te, 1)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
        return
    t = kind == "dx"
    w = torch.randn(1, *((256, k) if t else (k, 256)), device=dev, generator=g).bfloat16()
    assert gm.gmm_variant(x, w, t) == "wgmma"
    _max_close(gm.gmm_cuda(x, w, te, transpose_w=t), gm.gmm_torch(x, w, te, transpose_w=t), 2**-7)


def test_gmm_fn_through_gmm_matches_torch(dev):
    """The model's path: gmm on CUDA tensors with grad runs GmmFn (the
    forward kernel twice, the dw kernel once), on fp32 weights cast to bf16
    as the layer does. y and dx agree with autograd through the plain
    version; dw, which GmmFn returns in fp32 as the JAX package's gmm VJP
    does, with the plain dw function (autograd through the plain version
    rounds it to bf16 at the weight's cast, as the JAX ragged form does)."""
    g = torch.Generator(device=dev).manual_seed(9)
    x, _, te = _gmm_problem(g, dev, torch.bfloat16, (200, 0, 310, 90), 128)
    x.requires_grad_()
    w = (torch.randn(4, 128, 160, device=dev, generator=g) / 128**0.5).requires_grad_()
    cot = torch.randn(x.shape[0], 160, device=dev, generator=g).bfloat16()
    before = (gm.launches_fwd, gm.launches_dw)
    y = gm.gmm(x, w, te)
    dx, dw = torch.autograd.grad(y, (x, w), cot)
    assert (gm.launches_fwd, gm.launches_dw) == (before[0] + 2, before[1] + 1)
    y_r = gm.gmm(x, w, te, backend="torch")
    (dx_r,) = torch.autograd.grad(y_r, (x,), cot)
    dw_r = gm.gmm_dw_torch(x.detach(), cot, te, 4)
    assert dw.dtype == torch.float32 and dx.dtype == torch.bfloat16
    _max_close(y.detach(), y_r.detach(), 2**-7)
    _max_close(dx, dx_r, 2**-7)
    torch.testing.assert_close(dw, dw_r, rtol=0, atol=1e-4 * float(dw_r.abs().max()))


def test_gmm_kernel_rejects_what_it_does_not_take(dev):
    x = torch.rand(256, 16, device=dev)
    w = torch.rand(2, 16, 8, device=dev)
    te = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 128"):
        gm.gmm_cuda(x, w, torch.zeros(4, dtype=torch.int32, device=dev))
    with pytest.raises(TypeError, match="int32"):
        gm.gmm_cuda(x, w, te.long())
    with pytest.raises(TypeError):
        gm.gmm_cuda(x.half(), w.half(), te)
    with pytest.raises(ValueError, match="against"):
        gm.gmm_cuda(x, w, te, transpose_w=True)


def test_gmm_bf16_aligned_call_takes_wgmma(dev):
    """bf16 with widths a multiple of 8 launches the wgmma kernels and moves
    their counters, not the simt ones; fp32 the simt kernels only."""
    g = torch.Generator(device=dev).manual_seed(3)
    x, real, te = _gmm_problem(g, dev, torch.bfloat16, (200, 0, 310, 90), 128)
    w = (torch.randn(4, 128, 160, device=dev, generator=g) / 128**0.5).bfloat16()
    gy = torch.randn(x.shape[0], 160, device=dev, generator=g).bfloat16()

    def counts():
        return (gm.launches_fwd_wgmma, gm.launches_fwd_simt, gm.launches_dw_wgmma,
                gm.launches_dw_simt, gm.launches_fwd, gm.launches_dw)

    before = counts()
    gm.gmm_cuda(x, w, te)
    gm.gmm_cuda(gy, w, te, transpose_w=True)
    gm.gmm_dw_cuda(x, gy, te, 4)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [2, 0, 1, 0, 2, 1]
    before = counts()
    gm.gmm_cuda(x.float(), w.float(), te)
    gm.gmm_dw_cuda(x.float(), gy.float(), te, 4)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [0, 1, 0, 1, 1, 1]


def _q4_problem(g, dev, b, d, out, dtype):
    """x [b, d] and a random packed int4 weight [d/2, out] with per-channel
    scales; the nibbles cover -8..7 at both positions."""
    x = torch.randn(b, d, device=dev, generator=g).to(dtype)
    p = torch.randint(-128, 128, (d // 2, out), device=dev, generator=g).to(torch.int8)
    s = torch.rand(out, device=dev, generator=g) * 0.1 + 0.01
    return x, p, s


@pytest.mark.parametrize(
    "dtype,b,d,out",
    [
        (torch.bfloat16, 4, 2048, 2048),  # lm_1b3's wq..wo at decode's 4 rows
        (torch.bfloat16, 4, 5504, 2048),  # its down projection: 43 boxes over 8 ranks
        (torch.bfloat16, 4, 2048, 5504),  # its gate / up
        (torch.bfloat16, 1, 2048, 2048),  # mma from here to the next comment: B 1
        (torch.bfloat16, 8, 5504, 2048),  # B 8: one n-tile full
        (torch.bfloat16, 13, 2048, 5504),  # two n-tiles, the second part empty
        (torch.bfloat16, 64, 2048, 5504),  # B 64: eight n-tiles
        (torch.bfloat16, 64, 5504, 2048),  # B 64: x staged a box at a time
        (torch.bfloat16, 4, 2000, 2048),  # 1000 packed rows: a last box of 40 rows
        (torch.bfloat16, 3, 1000, 2048),  # 500: two boxes a rank, the last of 52 rows
        (torch.bfloat16, 2, 32768, 16),  # one strip of 16 channels, x in two chunks
        (torch.bfloat16, 4, 128, 336),  # one box of 64 rows, a last strip of 16 channels
        (torch.bfloat16, 1, 2048, 200),  # simt from here: an out that fits no 16-channel step
        (torch.bfloat16, 64, 100, 130),  # the most rows the kernel takes, a ragged d
        (torch.bfloat16, 4, 2004, 2048),  # d % 8 != 0
        (torch.float32, 3, 128, 384),  # tiny's widths in fp32
        (torch.float32, 7, 64, 33),  # out % 4 != 0: byte loads
        (torch.float32, 4, 5504, 2048),  # a K tail past 512 packed rows
    ],
)
def test_q4_matmul_kernel_matches_plain(dev, dtype, b, d, out):
    """Row 14 against its plain version, in the variant
    ``q4_matmul_variant`` names (mma for bf16 x with d % 8 == 0 and out %
    16 == 0, simt for the rest): bf16 to one bf16 step plus 1e-4 of the
    largest magnitude (fp32 sums of exact products in another order, one
    rounding); fp32 to 1e-4 relative plus the same absolute term. Every
    output is written (its memory held NaN before the call); only the
    chosen variant's counter moves."""
    g = torch.Generator(device=dev).manual_seed(b * d + out)
    x, p, s = _q4_problem(g, dev, b, d, out, dtype)
    variant = q4m.q4_matmul_variant(x, p, s)
    assert variant == ("mma" if dtype == torch.bfloat16 and d % 8 == 0 and out % 16 == 0
                       else "simt")
    before = _q4_counts()
    junk = torch.full((b * out * 4,), float("nan"), device=dev)
    del junk  # the allocator hands this block to y: an unwritten element shows
    y = q4m.q4_matmul_cuda(x, p, s)
    assert _q4_counts() == tuple(
        n + d for n, d in zip(before, (1, variant == "mma", variant == "simt")))
    ref = q4m.q4_matmul_torch(x, p, s)
    assert y.dtype == dtype and y.shape == (b, out) and bool(torch.isfinite(y.float()).all())
    _max_close(y, ref, 2**-7 if dtype == torch.bfloat16 else 1e-4)


def _q4_counts():
    return q4m.launches, q4m.launches_mma, q4m.launches_simt


def test_q4_outside_the_mma_conditions_takes_simt(dev):
    """The same weight's call takes simt when x is fp32 or x's base is 8
    bytes off 16, mma when both are right; a weight whose base is off 16
    takes simt even for a right x. Each result against the plain version."""
    g = torch.Generator(device=dev).manual_seed(3)
    x, p, s = _q4_problem(g, dev, 4, 2048, 2048, torch.bfloat16)
    flat = torch.empty(4 * 2048 + 4, dtype=torch.bfloat16, device=dev)
    x_off = flat[4:].view(4, 2048)
    x_off.copy_(x)
    pflat = torch.empty(1024 * 2048 + 8, dtype=torch.int8, device=dev)
    p_off = pflat[8:].view(1024, 2048)
    p_off.copy_(p)
    for xx, pp, want in ((x, p, "mma"), (x.float(), p, "simt"), (x_off, p, "simt"),
                         (x, p_off, "simt"), (x, p, "mma")):
        assert q4m.q4_matmul_variant(xx, pp, s) == want
        before = _q4_counts()
        y = q4m.q4_matmul_cuda(xx, pp, s)
        assert _q4_counts() == tuple(
            n + d for n, d in zip(before, (1, want == "mma", want == "simt")))
        _max_close(y, q4m.q4_matmul_torch(xx, pp, s), 2**-7 if xx.dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("b,kp,out", [(4, 1024, 2048), (4, 1024, 5504), (4, 2752, 2048),
                                       (64, 2752, 2048), (1, 1000, 2048), (2, 16384, 16),
                                       (4, 64, 336), (13, 250, 5504)])
def test_q4_geometry_mirror_matches_the_library(dev, b, kp, out):
    """``mma_geometry``, the Python mirror over which the CPU tests emulate
    the mma kernel's cluster split, chooses the strips and blocks a cluster
    that the library's launch does (``q4_geometry``), on 132 SMs and on this
    card's count."""
    import ctypes

    lib = q4m._library()
    for sms in (132, torch.cuda.get_device_properties(dev).multi_processor_count):
        g = (ctypes.c_int * 5)()
        assert lib.q4_geometry(b, kp, out, sms, g) == 0
        strips, cl, ranks = q4m.mma_geometry(kp, out, sms)
        assert (g[0], g[1]) == (strips, cl)
        assert len(ranks) == cl and ranks[0][0] == 0 and ranks[-1][1] == -(-kp // 64)


def test_q4_weight_reloaded_in_place_and_refusals_after_a_good_call(dev):
    """A layer's weight checked once: after a good call, an in-place reload
    of p and s (load_state_dict's copy_) gives the new weight's product; a
    bad x, a p of another shape and an s of another dtype each still raise
    with the checks' messages."""
    from orion_tpu_torch.quant import Int4Dense

    g = torch.Generator(device=dev).manual_seed(5)
    layer = Int4Dense(2048, 2048, torch.bfloat16, device=dev)
    x, p, s = _q4_problem(g, dev, 4, 2048, 2048, torch.bfloat16)
    layer.load_state_dict({"weight_p4": p, "weight_s": s})
    with torch.inference_mode():
        _max_close(layer(x), q4m.q4_matmul_torch(x, p, s), 2**-7)
        _, p2, s2 = _q4_problem(g, dev, 4, 2048, 2048, torch.bfloat16)
        layer.load_state_dict({"weight_p4": p2, "weight_s": s2})
        _max_close(layer(x), q4m.q4_matmul_torch(x, p2, s2), 2**-7)
        with pytest.raises(ValueError, match="packed kernel rows"):
            q4m.q4_matmul_cuda(x[:, :1024].contiguous(), layer.weight_p4, layer.weight_s)
        with pytest.raises(TypeError, match="bf16 or fp32"):
            q4m.q4_matmul_cuda(x.half(), layer.weight_p4, layer.weight_s)
        with pytest.raises(TypeError, match="float32"):
            q4m.q4_matmul_cuda(x, layer.weight_p4, layer.weight_s.double())
        with pytest.raises(ValueError, match="packed kernel rows"):
            q4m.q4_matmul_cuda(x, layer.weight_p4[:512], layer.weight_s)
        _max_close(layer(x), q4m.q4_matmul_torch(x, p2, s2), 2**-7)


def test_int4_model_decode_uses_the_kernel(dev):
    """An int4 tiny model's decode step on the card: one q4 launch per dense
    layer (4 attention + 3 MLP per block), logits within 1e-4 of the CPU's
    split form; the prefill's 2 x 40 rows stay on the split form."""
    from orion_tpu_torch.generate import quantize_for_decode

    cpu = quantize_for_decode(TransformerLM(TINY, device="cpu"), "int4")
    gpu = TransformerLM(TINY, device=dev, quant="int4")
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        before = q4m.launches
        lg, st = gpu.prefill_last(tokens.to(dev))
        assert q4m.launches == before
        lg2, _ = gpu.decode_step(tokens[:, -1].to(dev), st, 40)
        assert q4m.launches == before + 7 * TINY.n_layers
        lc, stc = cpu.prefill_last(tokens)
        lc2, _ = cpu.decode_step(tokens[:, -1], stc, 40)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lg2.cpu(), lc2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,n", [(2048, 2048), (1000, 1001), (300, 4100), (9, 128)])
def test_adafactor_kernels_match_plain(dev, m, n):
    """Rows 11-13 against their plain versions: the sums (positive fp32 sums
    in another order) within 1e-4 relative of each element, an all-zero row
    and column included (their sums are eps alone); the squared sum within
    1e-4 relative; apply exactly as the plain version (the same roundings in
    the same order), and with the flag 0 nothing changes, bitwise."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    grad = torch.randn(m, n, device=dev, generator=g) * 1e-3
    grad[m // 2] = 0.0
    grad[:, n // 3] = 0.0
    s2 = torch.tensor([0.37], device=dev)
    before = (af.launches_sums, af.launches_rms, af.launches_apply)
    s0, s1 = af.adafactor_sums_cuda(grad, s2, 1e-30)
    r0, r1 = af.adafactor_sums_torch(grad, s2, 1e-30)
    for got, ref in ((s0, r0), (s1, r1)):
        assert got.shape == ref.shape
        assert float(((got - ref).abs() / ref).max()) <= 1e-4
    r = torch.rand(m, device=dev, generator=g) + 0.5
    c = torch.rand(n, device=dev, generator=g) + 0.5
    rms = af.adafactor_rms_cuda(grad, r, c)
    assert abs(float(rms) - float(af.adafactor_rms_torch(grad, r, c))) <= 1e-4 * float(
        af.adafactor_rms_torch(grad, r, c))
    p = torch.randn(m, n, device=dev, generator=g)
    p_ref = p.clone()
    for flag in (0, 1):
        f = torch.tensor([flag], dtype=torch.int32, device=dev)
        got = af.adafactor_apply_cuda(grad, p, r * -1e-2, c, f)
        assert got.data_ptr() == p.data_ptr()  # in place
        af.adafactor_apply_torch(grad, p_ref, r * -1e-2, c, f)
        assert torch.equal(p, p_ref), flag
    # the sums and the squared sum are two launches a call (tiles, then their sum)
    assert (af.launches_sums, af.launches_rms, af.launches_apply) == (
        before[0] + 2, before[1] + 2, before[2] + 2)


def test_adafactor_tiling_covers_every_row_and_column(dev):
    """The source's tiling: 1024-column strips over all n, row chunks over
    all m, each chunk at least 8 rows (one a warp) where m allows."""
    for m, n in ((32000, 2048), (2048, 5504), (5504, 2048), (2048, 2048), (9, 128), (1, 1),
                 (1000, 1001)):
        n_ct, n_rc, rows = af.tiling(m, n)
        assert n_ct * 1024 >= n > (n_ct - 1) * 1024
        assert n_rc * rows >= m > (n_rc - 1) * rows and n_rc <= -(-m // 8)


def test_adafactor_strided_gradient_launches_and_strided_param_raises(dev, monkeypatch):
    """The kernels' gate has no layout condition, as the JAX package's: a
    gradient that is a transposed view launches all three passes and updates
    p bitwise as its contiguous copy does; a strided p, which apply writes in
    place, raises in the wrapper."""
    monkeypatch.setattr(af, "_MIN_KERNEL_ELEMS", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    grad_t = torch.randn(384, 256, device=dev, generator=g) * 1e-3  # the JAX [in, out]
    p0 = torch.randn(256, 384, device=dev, generator=g) * 0.02
    dims = {"w": af.factored_dims((256, 384), transposed=True)}
    got = []
    for grad in (grad_t.t(), grad_t.t().contiguous()):
        p = {"w": p0.clone()}
        before = (af.launches_sums, af.launches_rms, af.launches_apply)
        af.apply_updates({"w": grad}, p, af.init(p, dims), lr=1e-2, scale=1.0, finite=True,
                         dims=dims)
        assert (af.launches_sums, af.launches_rms, af.launches_apply) == (
            before[0] + 2, before[1] + 2, before[2] + 1)
        got.append(p["w"])
    assert torch.equal(got[0], got[1])
    p = {"w": p0.t().contiguous().t()}  # [256, 384], strided
    with pytest.raises(ValueError, match="contiguous"):
        af.apply_updates({"w": grad_t.t()}, p, af.init(p, dims), lr=1e-2, scale=1.0, finite=True,
                         dims=dims)


def test_adafactor_fused_trainer_matches_plain_on_the_card(dev, monkeypatch):
    """3 fp32 steps of a tiny model with adafactor_fused, its leaves lowered
    into the kernels' gate, against optimizer='adafactor' (the plain
    formulas) on the same card: losses within 1e-5, params within 2e-5
    relative plus 1e-7 (JAX's own fused-vs-optax tolerance)."""
    from orion_tpu_torch.training.data import SyntheticDataset
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    monkeypatch.setattr(af, "_MIN_KERNEL_ELEMS", 0)
    runs = {}
    for opt in ("adafactor", "adafactor_fused"):
        cfg = TrainConfig(model=TINY, steps=3, batch_size=2, seq_len=64, lr=1e-3,
                          warmup_steps=1, optimizer=opt)
        tr = Trainer(cfg, device=dev)
        ds = SyntheticDataset(TINY.vocab_size, 64)
        before = af.launches_apply
        losses = [tr.step(torch.from_numpy(ds.batch(0, i, 2)).long())["loss"] for i in range(3)]
        runs[opt] = (losses, {n: p.detach().clone() for n, p in tr.params.items()},
                     af.launches_apply - before)
    factored = sum(p.dim() == 2 for p in runs["adafactor"][1].values())
    assert runs["adafactor"][2] == 0 and runs["adafactor_fused"][2] == 3 * factored
    np.testing.assert_allclose(runs["adafactor_fused"][0], runs["adafactor"][0], rtol=0, atol=1e-5)
    for n, ref in runs["adafactor"][1].items():
        torch.testing.assert_close(runs["adafactor_fused"][1][n], ref, rtol=2e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# LRA, the feature maps and bf16 storage on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,over", [("lra_listops_linear", {}), ("lra_text_softmax", {}),
                                       ("lra_text_linear", {"feature_map": "favor"})])
def test_lra_classifier_on_the_card_matches_the_cpu(dev, name, over):
    """The classifier's logits, loss and every gradient on the card against
    the CPU, same params, fp32 (no TF32), rows the key mask pads: 1e-4 of
    the largest magnitude beside 1e-4 relative. Neither side runs a kernel:
    the masked bidirectional forms are plain torch, as in the JAX package."""
    from orion_tpu_torch.models.classifier import LRAClassifier
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.train_lra import lra_loss
    from orion_tpu_torch.training.trainer import param_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(name), max_seq_len=512, **over)
    cpu = LRAClassifier(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    gpu = LRAClassifier(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, 16, (2, 300), generator=g)
    mask = torch.arange(300)[None, :] < torch.tensor([[300], [171]])
    labels = torch.tensor([1, 0])
    before = causal_dot.launches
    res = {}
    for label, model, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        loss, _ = lra_loss(model, toks.to(d), labels.to(d), mask.to(d))
        loss.backward()
        res[label] = (model(toks.to(d), mask.to(d)).detach().cpu(), loss.detach().cpu(),
                      {n: x.cpu() for n, x in param_grads(dict(model.named_parameters())).items()})
    assert causal_dot.launches == before
    for got, ref in zip(res["gpu"][:2], res["cpu"][:2]):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    for n, ref in res["cpu"][2].items():
        torch.testing.assert_close(res["gpu"][2][n], ref, rtol=1e-4,
                                   atol=1e-4 * max(float(ref.abs().max()), 1e-30), msg=n)


@pytest.mark.parametrize("over", [{"feature_map": "favor"},
                                  {"feature_map": "learnable", "tie_embeddings": False}])
def test_feature_maps_through_rows_1_3_4_match_torch(dev, over):
    """bf16 at Dh 128 (d 256, 2 heads): every launch of rows 1, 3 and 4 on
    their wgmma kernels, the loss and every gradient within chip_smoke's
    lm_1b3 limits of backend="torch" (loss 1e-2, gradients 5e-2 relative
    L2); the fixed favor_proj gets no gradient on either side."""
    from orion_tpu_torch.training.trainer import param_grads

    cfg = dataclasses.replace(TINY, dtype="bfloat16", d_model=256, n_heads=2, n_layers=3,
                              remat=True, remat_skip=1, **over)
    batch = torch.randint(0, cfg.vocab_size, (2, 300), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    results = {}
    for backend in ("cuda", "torch"):
        model = TransformerLM(dataclasses.replace(cfg, backend=backend), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(1))
        before = _wgmma_simt_counts()
        loss = lm_loss(model, batch)
        loss.backward()
        moved = tuple(a - b for a, b in zip(_wgmma_simt_counts(), before))
        results[backend] = (float(loss), param_grads(dict(model.named_parameters())), moved)
    assert results["cuda"][2] == (3 + 2, 3, 3, 0, 0, 0)  # wgmma only; 2 blocks recomputed
    assert results["torch"][2] == (0,) * 6
    (loss_k, grads_k, _), (loss_t, grads_t, _) = results["cuda"], results["torch"]
    assert abs(loss_k - loss_t) <= 1e-2
    for n, ref in grads_t.items():
        if n.endswith("favor_proj"):
            assert not grads_k[n].any() and not ref.any()
            continue
        assert float((grads_k[n].float() - ref.float()).norm() / ref.float().norm()) <= 5e-2, n


def _wgmma_simt_counts():
    return (causal_dot.launches_wgmma, causal_dot.launches_dq_wgmma, causal_dot.launches_rev_wgmma,
            causal_dot.launches_simt, causal_dot.launches_dq_simt, causal_dot.launches_rev_simt)


def test_sr_round_bf16_on_the_card_bitwise_equals_the_cpu(dev):
    from orion_tpu_torch.training.trainer import sr_noise_bits, sr_round_bf16

    x = torch.randn(1 << 20, generator=torch.Generator().manual_seed(0)) * 5
    x[:3] = torch.tensor([float("inf"), -float("inf"), float("nan")])
    for words in ((0, 0), (0xDEADBEEF, 0x12345678), (0xFFFFFFFF, 0xFFFFFFFF)):
        assert torch.equal(sr_noise_bits(words, 4099, dev).cpu(), sr_noise_bits(words, 4099))
        got = sr_round_bf16(x.to(dev), words).cpu().view(torch.int16)
        assert torch.equal(got, sr_round_bf16(x, words).view(torch.int16))


def test_bf16_sr_trainer_on_the_card_matches_the_cpu(dev):
    """Two fp32-compute AdamW steps with bf16 storage, the card against the
    CPU from the same weights and batches: the same key words, so the same
    roundings wherever the fp32 values agree; the losses within 1e-4, the
    params within two bf16 steps (the two fp32 values p + u may straddle a
    bf16 value) plus 2^-7 of the leaf's largest update (a bf16 leaf's
    gradient is bf16, rounded from sums in another order). eps 1e-2 keeps
    Adam's first update continuous in the gradient."""
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(model=TINY, steps=3, batch_size=2, seq_len=64, warmup_steps=1, lr=1e-3,
                      eps=1e-2, param_storage="bfloat16_sr")
    cpu, gpu = Trainer(cfg, device="cpu"), Trainer(cfg, device=dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    init = {n: p.detach().float().clone() for n, p in cpu.params.items()}
    g = torch.Generator().manual_seed(4)
    for _ in range(2):
        b = torch.randint(0, TINY.vocab_size, (2, 65), generator=g)
        assert abs(gpu.step(b.to(dev))["loss"] - cpu.step(b)["loss"]) <= 1e-4
    for n, p in cpu.params.items():
        q = gpu.params[n].cpu()
        assert q.dtype == p.dtype == (torch.bfloat16 if p.dim() >= 2 else torch.float32), n
        step = torch.maximum(p.float().abs(), q.float().abs()) * 2.0 ** -7
        moved = (p.float() - init[n]).abs().max()
        assert bool(((q.float() - p.float()).abs() <= 2 * step + 2.0 ** -7 * moved).all()), n


# -- the serving programs on the card ---------------------------------------

_SERVE_TINY = dataclasses.replace(TINY, n_layers=3, layer_types=("linear", "softmax", "swa"),
                                  window=16, max_seq_len=256)


def _serve_run(model, dev, sample):
    """Slot 0 prefilled solo and inserted, slot 1 staged with 40 tokens and
    fed in pieces of 16, slot 2 free (holding a random state): three
    unified chunks of 4 steps -> (tokens [3, 12], states, slot 2 before)."""
    from orion_tpu_torch import generate as gen
    from orion_tpu_torch.models.transformer import (extract_decode_slot, init_decode_state,
                                                    insert_decode_slot)

    cfg = model.cfg
    g = torch.Generator().manual_seed(5)
    p0 = torch.randint(0, cfg.vocab_size, (1, 21), generator=g).to(dev)
    p1 = torch.randint(0, cfg.vocab_size, (1, 40), generator=g).to(dev)
    states = init_decode_state(cfg, 3, dev)
    with torch.inference_mode():
        for st in states:
            for x in st.values():
                x[2] = torch.randn(x.shape[1:], generator=g).to(dev)
    keys = gen.request_keys(1, 3, dev)
    c = gen.prefill_carry(model, p0, sample, keys[:1])
    insert_decode_slot(states, c[1], 0)
    free = extract_decode_slot(states, 2)
    z = torch.zeros(3, dtype=torch.long, device=dev)
    carry = (z.clone().index_fill_(0, torch.tensor([0], device=dev), int(c[0][0])), states,
             torch.tensor([21, 0, 0], device=dev), z.clone(), torch.zeros(3, dtype=torch.bool,
                                                                          device=dev))
    pbuf = torch.zeros(3, 48, dtype=torch.long, device=dev)
    pbuf[1, :40] = p1[0]
    plen = torch.tensor([0, 40, 0], device=dev)
    active = torch.tensor([True, True, False], device=dev)
    out = []
    for _ in range(3):
        carry, toks = gen.decode_batched_prefill_chunk(model, carry, keys, active, pbuf, plen, z,
                                                       4, 16, sample)
        out.append(toks)
    return torch.cat(out, 1), carry, free


def test_serving_programs_on_the_card_match_the_cpu(dev):
    """A tiny fp32 model with a linear, a softmax and a swa layer: the
    unified chunks on the card emit the CPU's greedy tokens and leave the
    states within 1e-4; row 1 takes its simt kernel once per piece (3
    chunks), and the free slot's state -- the ring included -- is bitwise
    as it was."""
    from orion_tpu_torch import generate as gen
    from orion_tpu_torch.models.transformer import extract_decode_slot

    cpu = TransformerLM(_SERVE_TINY, device="cpu")
    gpu = TransformerLM(_SERVE_TINY, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    greedy = gen.SampleConfig(temperature=0.0)
    before = causal_dot.launches_simt
    toks, carry, free = _serve_run(gpu, dev, greedy)
    assert causal_dot.launches_simt - before == 1 + 3  # the solo prefill, three pieces
    ref, ref_carry, _ = _serve_run(cpu, torch.device("cpu"), greedy)
    assert torch.equal(toks.cpu(), ref)
    assert torch.equal(carry[2].cpu(), ref_carry[2])
    for st, rst in zip(carry[1], ref_carry[1]):
        for k in st:
            torch.testing.assert_close(st[k][:2].cpu(), rst[k][:2], rtol=1e-4, atol=1e-4)
    held = extract_decode_slot(carry[1], 2)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(held, free) for k in a)


def test_prefill_pieces_take_row_1_wgmma_with_a_state(dev):
    """bf16 at Dh 128: each 64-token piece's linear layer runs row 1's wgmma
    kernel seeded with (S, z); the pieces' last logits within chip_smoke's
    LOGITS_ATOL of prefill_last's, and the same greedy token."""
    from orion_tpu_torch.generate import cast_params_for_inference
    from orion_tpu_torch.models.transformer import init_decode_state

    cfg = dataclasses.replace(TINY, d_model=256, n_heads=2, dtype="bfloat16", max_seq_len=512)
    model = cast_params_for_inference(TransformerLM(cfg, device=dev))
    p = torch.randint(0, cfg.vocab_size, (1, 300), generator=torch.Generator().manual_seed(0))
    p = p.to(dev)
    states = init_decode_state(cfg, 1, dev)
    before = causal_dot.launches_wgmma
    with torch.inference_mode():
        for off in range(0, 300, 64):
            n = min(64, 300 - off)
            piece = torch.nn.functional.pad(p[:, off:off + n], (0, 64 - n))
            lg, states = model.prefill_extend_step(piece, states, off, n)
        assert causal_dot.launches_wgmma - before == cfg.n_layers * 5
        ref, _ = model.prefill_last(p)
    assert float((lg - ref).abs().max()) <= 0.125 and int(lg.argmax()) == int(ref.argmax())


def test_decode_caches_in_place_and_masked_on_the_card(dev):
    from orion_tpu_torch.models.transformer import snapshot_decode_state

    model = TransformerLM(_SERVE_TINY, device=dev)
    tokens = torch.randint(0, 256, (3, 20), generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        _, states = model.prefill_last(tokens)
        ptrs = [st["k"].data_ptr() for st in states[1:]]
        before = snapshot_decode_state(states)
        write = torch.tensor([True, False, True], device=dev)
        for i in range(20):  # the ring (16) wraps
            _, states = model.decode_step(tokens[:, i], states, torch.full((3,), 20 + i,
                                                                           device=dev), write)
    assert [st["k"].data_ptr() for st in states[1:]] == ptrs
    for st, old in zip(states, before):
        for k in st:
            assert torch.equal(st[k][1], old[k][1]) and not torch.equal(st[k][0], old[k][0])


def test_session_rewind_on_the_card_is_bitwise(dev):
    from orion_tpu_torch import generate as gen
    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.serving import DecodeRequest, DecodeSession

    model = TransformerLM(_SERVE_TINY, device=dev)
    session = DecodeSession(model, chunk=4)
    req = DecodeRequest(np.arange(30)[None] % 256, 16, gen.SampleConfig(temperature=0.7), seed=3)
    ref = session.run(req)
    with inject.inject(inject.FaultPlan().poison_decode_state_at(2)):
        res = session.run(req)
    assert (res.status, res.rewinds) == ("ok", 1)
    np.testing.assert_array_equal(res.tokens, ref.tokens)


_ROWS_CFG = dataclasses.replace(TINY, d_model=512, n_heads=4, n_layers=2, dtype="bfloat16",
                                layer_types=("linear", "swa"), window=64, max_seq_len=512,
                                vocab_size=4096)


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_decode_step_rows_do_not_depend_on_the_batch(dev, quant):
    """C1 on the card: a 4-row decode step's row 2 against that row alone,
    op by op (``utils/row_probe.py``), bf16 at Dh 128: with the products at
    ``DECODE_ROWS`` rows no op's row differs and the logits and states are
    bitwise (int4's dense products on row 14's mma kernel)."""
    from orion_tpu_torch import generate as gen
    from orion_tpu_torch.models.transformer import init_decode_state, insert_decode_slot
    from orion_tpu_torch.utils.row_probe import row_variant_ops

    model = gen.cast_params_for_inference(TransformerLM(_ROWS_CFG, device=dev))
    if quant:
        model = gen.quantize_for_decode(model, quant)
    states = init_decode_state(_ROWS_CFG, 4, dev)
    toks, ts = [], []
    for j in range(4):
        p = torch.randint(0, 4096, (1, 90 + 17 * j), generator=torch.Generator().manual_seed(j))
        c = gen.prefill_carry(model, p.to(dev), gen.SampleConfig(temperature=0.0),
                              gen.request_keys(j, 1, dev))
        insert_decode_slot(states, c[1], j)
        toks.append(c[0])
        ts.append(c[2])
    before = q4m.launches_mma
    r = row_variant_ops(model, torch.cat(toks), states, torch.tensor(ts, device=dev), 2)
    assert r["misaligned"] is None and r["culprits"] == [], r
    assert r["logits_equal"] and r["states_equal"]
    assert q4m.launches_mma - before == (2 * 2 * 7 if quant == "int4" else 0)


@pytest.mark.parametrize("mode", ["host", "inscan"])
def test_slot_engine_on_the_card_equals_one_row_generate(dev, mode):
    """``SlotEngine`` at 4 slots on a bf16 linear model (row 1's wgmma
    kernel in every prefill and piece): 6 greedy requests, admitted as
    slots free up, each bitwise its one-row ``generate``."""
    from orion_tpu_torch import generate as gen
    from orion_tpu_torch.serving import DecodeRequest, SlotEngine

    cfg = dataclasses.replace(_ROWS_CFG, layer_types=("linear", "linear"))
    model = gen.cast_params_for_inference(TransformerLM(cfg, device=dev))
    greedy = gen.SampleConfig(temperature=0.0)
    # host admission without buckets: the prefill of a one-row generate (a
    # bucket's padded length is another row count for the dense products)
    eng = SlotEngine(model, slots=4, chunk=4, device=dev,
                     prefill_buckets=(64, 128, 256) if mode == "inscan" else (),
                     prefill_chunk=64 if mode == "inscan" else 0)
    prompts = [np.random.default_rng(i).integers(0, 4096, (1, n))
               for i, n in enumerate((200, 37, 130, 64, 90, 250))]
    done, pending = {}, list(enumerate(prompts))
    while pending or eng.busy:
        while pending and eng.has_free_slot:
            i, p = pending.pop(0)
            eng.admit(DecodeRequest(p, 12, greedy, seed=i), tag=i)
        done.update(dict(eng.step()))
    for i, p in enumerate(prompts):
        ref = gen.generate(model, torch.from_numpy(p).to(dev), 12, greedy, i).cpu().numpy()
        np.testing.assert_array_equal(done[i].tokens, ref, err_msg=f"{mode} request {i}")


def _server_case(dev):
    from orion_tpu_torch import generate as gen
    from orion_tpu_torch.serving import DecodeRequest

    cfg = dataclasses.replace(_ROWS_CFG, layer_types=("linear", "linear"))
    model = gen.cast_params_for_inference(TransformerLM(cfg, device=dev))
    greedy = gen.SampleConfig(temperature=0.0)
    prompts = [np.random.default_rng(i).integers(0, 4096, (1, n))
               for i, n in enumerate((200, 37, 130, 64, 90, 250))]
    return model, [DecodeRequest(p, 12, greedy, seed=i) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("mode", ["host", "inscan"])
def test_server_on_the_card_equals_the_slot_engine(dev, mode):
    """``Server`` at 4 slots on the card (the model's device by default): the
    6 requests of the engine test, submitted up front, each bitwise the same
    request served through a bare ``SlotEngine`` with the same admissions,
    and row 1's launches the same in both."""
    from orion_tpu_torch.serving import ServeConfig, Server, SlotEngine

    model, reqs = _server_case(dev)
    buckets = (64, 128, 256) if mode == "inscan" else ()
    pchunk = 64 if mode == "inscan" else 0
    before = causal_dot.launches_wgmma
    eng = SlotEngine(model, slots=4, chunk=4, device=dev, prefill_buckets=buckets,
                     prefill_chunk=pchunk)
    done, pending = {}, list(enumerate(reqs))
    while pending or eng.busy:
        while pending and eng.has_free_slot:
            i, r = pending.pop(0)
            eng.admit(r, tag=i)
        done.update(dict(eng.step()))
    engine_launches = causal_dot.launches_wgmma - before
    srv = Server(model, ServeConfig(chunk=4, slots=4, max_inflight=8,
                                    prefill_buckets=",".join(map(str, buckets)) or "off",
                                    prefill_chunk=pchunk))
    assert srv.device == dev and srv.engine.device == dev
    ps = [srv.submit(r) for r in reqs]
    before = causal_dot.launches_wgmma
    assert srv.serve(drain_when_idle=True) == 0
    assert causal_dot.launches_wgmma - before == engine_launches > 0
    for i, p in enumerate(ps):
        assert p.result.status == "ok"
        np.testing.assert_array_equal(p.result.tokens, done[i].tokens, err_msg=f"{mode} {i}")
    srv.close()


def test_server_sigterm_drain_on_the_card(dev):
    """A real SIGTERM at engine boundary 1 with requests queued beyond the
    slots: serve() returns 0, every request completes bitwise its engine
    run, a later submit is rejected, health SERVING -> DRAINING -> DEAD."""
    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.serving import Health, RejectedError, ServeConfig, Server, SlotEngine

    model, reqs = _server_case(dev)
    eng = SlotEngine(model, slots=4, chunk=4, device=dev)
    for i, r in enumerate(reqs[:4]):
        eng.admit(r, tag=i)
    done = {}
    while eng.busy:
        done.update(dict(eng.step()))
    srv = Server(model, ServeConfig(chunk=4, slots=2, max_inflight=8, prefill_buckets="off",
                                    prefill_chunk=0))
    ps = [srv.submit(r) for r in reqs[:4]]
    plan = inject.FaultPlan().preempt_at_chunk(1)
    with inject.inject(plan):
        assert srv.serve() == 0
    assert plan.delivered == ["serve.chunk@1"] and srv.health.state is Health.DEAD
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(p.result.tokens, done[i].tokens)
    with pytest.raises(RejectedError):
        srv.submit(reqs[0])
    edges = [(a.value if a else None, b.value) for a, b, _, _ in srv.health.history]
    assert ("serving", "draining") in edges and ("draining", "dead") in edges


def test_stores_prefix_hit_on_the_card_equals_a_cold_inscan_run(dev, tmp_path):
    """The prefix store on the card, a bf16 linear model at D 128 (row 1's
    wgmma kernel in the pieces and the publish): request 0 declares a
    256-token prefix and misses (its publish runs row 1 once a layer), 1-2
    hit and run pieces over their suffixes only; every request bitwise the
    same request served cold in-scan by a Server without a store."""
    from orion_tpu_torch import generate as gen
    from orion_tpu_torch.serving import DecodeRequest, ServeConfig, Server

    cfg = dataclasses.replace(_ROWS_CFG, layer_types=("linear", "linear"))
    model = gen.cast_params_for_inference(TransformerLM(cfg, device=dev))
    pre = np.random.default_rng(0).integers(0, 4096, (1, 256))
    prompts = [np.concatenate([pre, np.random.default_rng(10 + i).integers(0, 4096, (1, n))], 1)
               for i, n in enumerate((40, 77, 130))]
    sampled = gen.SampleConfig(temperature=0.8, top_k=50)
    reqs = [DecodeRequest(p, 12, sampled, seed=i, prefix_len=256) for i, p in enumerate(prompts)]
    kw = dict(chunk=4, slots=4, max_inflight=8, prefill_buckets="128,256,512", prefill_chunk=64)
    cold_srv = Server(model, ServeConfig(**kw))
    cold = [cold_srv.submit(r) for r in reqs]
    assert cold_srv.serve(drain_when_idle=True) == 0
    srv = Server(model, ServeConfig(**kw, prefix_dir=str(tmp_path / "prefix")))
    before = causal_dot.launches_wgmma
    got = [srv.submit(reqs[0])]
    assert srv.serve(drain_when_idle=True) == 0
    pieces = len(srv.flight.events("prefill_piece"))
    assert causal_dot.launches_wgmma - before == 2 * (pieces + 1)  # + the publish's prefill
    before = causal_dot.launches_wgmma
    got += [srv.submit(r) for r in reqs[1:]]
    assert srv.serve(drain_when_idle=True) == 0
    hit_pieces = len(srv.flight.events("prefill_piece")) - pieces
    assert hit_pieces == 2 + 3 and causal_dot.launches_wgmma - before == 2 * hit_pieces
    flat = srv.metrics.counters_flat()
    assert (flat["prefix_hits"], flat["prefix_misses"], flat["prefix_publishes"]) == (2, 1, 1)
    for i, (g, c) in enumerate(zip(got, cold)):
        assert g.result.status == "ok"
        np.testing.assert_array_equal(g.result.tokens, c.result.tokens, err_msg=f"request {i}")
    srv.close()
    cold_srv.close()


def test_stores_session_restart_on_the_card_equals_an_uninterrupted_run(dev, tmp_path):
    """A session on the card (bf16, a linear and a swa layer: its (S, z) and
    its bf16 ring go to disk): turn 1, then turn 2 suspended by a SIGTERM
    and resumed from disk by a fresh Server, bitwise one uninterrupted
    request, greedy and sampled."""
    from orion_tpu_torch import generate as gen
    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.serving import DecodeRequest, ServeConfig, Server

    model = gen.cast_params_for_inference(TransformerLM(_ROWS_CFG, device=dev))
    p = np.random.default_rng(5).integers(0, 4096, (1, 150))
    empty = np.zeros((1, 0), np.int64)
    kw = dict(chunk=4, slots=2, max_inflight=8, prefill_buckets="off", prefill_chunk=0)
    for k, sample in enumerate((gen.SampleConfig(temperature=0.0),
                                gen.SampleConfig(temperature=0.8, top_k=50))):
        ref_srv = Server(model, ServeConfig(**kw))
        ref = ref_srv.submit(DecodeRequest(p, 30, sample, seed=9))
        assert ref_srv.serve(drain_when_idle=True) == 0
        cfg = ServeConfig(**kw, session_dir=str(tmp_path / f"s{k}"))
        srv1 = Server(model, cfg)
        t1 = srv1.submit(DecodeRequest(p, 10, sample, seed=9, session_id="conv"))
        assert srv1.serve(drain_when_idle=True) == 0
        t2a = srv1.submit(DecodeRequest(empty, 20, sample, session_id="conv"))
        with inject.inject(inject.FaultPlan().preempt_at_chunk(srv1.engine._chunk_counter + 1)):
            assert srv1.serve() == 0
        assert t2a.result.status == "suspended" and 0 < t2a.result.new_tokens < 20
        srv2 = Server(model, cfg)
        t2b = srv2.submit(DecodeRequest(empty, 20 - t2a.result.new_tokens, sample,
                                        session_id="conv"))
        assert srv2.serve(drain_when_idle=True) == 0 and t2b.result.status == "ok"
        total = np.concatenate([t1.result.tokens, t2a.result.tokens, t2b.result.tokens], 1)
        np.testing.assert_array_equal(total, ref.result.tokens, err_msg=f"sample {k}")
        srv2.close()
