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
and dS0 to 1e-4 relative plus 1e-4 of their largest magnitude, and the op's
forward + backward through ``CausalDotProductFn`` against autograd of the
plain form within the same limits. A model's backward through the kernels against
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
another order, through one log). The grouped matmul (rows 9, 10): y and dx
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
    ],
)
def test_causal_dot_norm_matches_plain(dev, dtype, bh, t, dk, dv, state):
    g = torch.Generator(device=dev).manual_seed(t)
    q = (torch.nn.functional.elu(torch.randn(bh, t, dk, device=dev, generator=g)) + 1).to(dtype)
    k = (torch.nn.functional.elu(torch.randn(bh, t, dk, device=dev, generator=g)) + 1).to(dtype)
    v = torch.randn(bh, t, dv, device=dev, generator=g).to(dtype)
    s0 = z0 = None
    if state:
        s0 = torch.randn(bh, dk, dv, device=dev, generator=g)
        z0 = torch.rand(bh, dk, device=dev, generator=g) * 10
    before = causal_dot.launches
    out, s, z = causal_dot.causal_dot_norm_cuda(q, k, v, s0, z0)
    assert causal_dot.launches == before + 1
    r_out, r_s, r_z = causal_dot.causal_dot_norm_plain(q, k, v, s0, z0)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), r_out.float(), rtol=2**-7, atol=1e-4)
    else:
        torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)
    for got, ref in ((s, r_s), (z, r_z)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


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


@pytest.mark.parametrize(
    "dtype,bh,t,dk,dv,state",
    [
        (torch.float32, 3, 70, 32, 24, False),
        (torch.float32, 2, 129, 128, 100, True),
        (torch.bfloat16, 5, 1, 16, 64, True),
        (torch.bfloat16, 4, 333, 128, 128, True),
        (torch.bfloat16, 2, 64, 100, 72, False),
    ],
)
def test_backward_kernels_match_plain(dev, dtype, bh, t, dk, dv, state):
    g = torch.Generator(device=dev).manual_seed(t + 1)
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
    before = (causal_dot.launches, causal_dot.launches_dq, causal_dot.launches_rev)
    _, _, _, num, den = causal_dot.causal_dot_norm_cuda(q, k, v, s0, z0, with_parts=True)
    _, _, _, r_num, r_den = causal_dot.causal_dot_norm_plain(q, k, v, s0, z0, with_parts=True)
    _max_close(num, r_num, 1e-4)
    _max_close(den, r_den, 1e-4)
    gnum, gden = causal_dot.quotient_rule(gout, r_num, r_den, 1e-6, dtype)
    got = (causal_dot.causal_dot_dq_den_cuda(gnum, v, k, gden, s0, z0),
           *causal_dot.causal_dot_rev_den_cuda(q, k, v, gnum, gden, gsf, gzf))
    assert (causal_dot.launches, causal_dot.launches_dq, causal_dot.launches_rev) == tuple(
        n + 1 for n in before)
    ref = (causal_dot.causal_dot_dq_den_plain(gnum, v, k, gden, s0, z0),
           *causal_dot.causal_dot_rev_den_plain(q, k, v, gnum, gden, gsf, gzf))
    for x, r in zip(got[:3], ref[:3]):
        assert x.dtype == dtype and x.shape == r.shape
        _max_close(x, r, 2**-7 if dtype == torch.bfloat16 else 1e-4)
    for x, r in zip(got[3:], ref[3:]):
        assert x.dtype == torch.float32
        _max_close(x, r, 1e-4)


@pytest.mark.parametrize(
    "dtype,bh,t,dk,dv,state",
    [
        (torch.float32, 3, 70, 32, 24, False),
        (torch.float32, 2, 129, 128, 100, True),
        (torch.bfloat16, 5, 1, 16, 64, True),
        (torch.bfloat16, 4, 333, 128, 128, True),
        (torch.bfloat16, 2, 64, 100, 72, False),
    ],
)
def test_raw_kernels_match_plain(dev, dtype, bh, t, dk, dv, state):
    """Rows 2 and 5 (the public op's forward and reverse pass) against their
    plain versions; ``state`` gives both an S0 and a dSf seed."""
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
    before = (causal_dot.launches_raw, causal_dot.launches_raw_rev)
    out, sf = causal_dot.causal_dot_cuda(q, k, v, s0)
    dk_, dv_, ds0 = causal_dot.causal_dot_rev_cuda(q, k, v, gout, gsf)
    assert (causal_dot.launches_raw, causal_dot.launches_raw_rev) == tuple(n + 1 for n in before)
    r_out, r_sf = causal_dot.causal_dot_plain(q, k, v, s0)
    assert out.dtype == dtype and out.shape == r_out.shape
    _max_close(out, r_out, 2**-7 if dtype == torch.bfloat16 else 1e-4)
    _max_close(sf, r_sf, 1e-4)
    for x, r in zip((dk_, dv_, ds0), causal_dot.causal_dot_rev_plain(q, k, v, gout, gsf)):
        assert x.dtype == torch.float32 and x.shape == r.shape
        _max_close(x, r, 1e-4)


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
    ],
)
def test_flash_kernels_match_plain(dev, dtype, bh, tq, tk, d, causal, window):
    g = torch.Generator(device=dev).manual_seed(tq + d)
    q = torch.randn(bh, tq, d, device=dev, generator=g).to(dtype)
    k = torch.randn(bh, tk, d, device=dev, generator=g).to(dtype)
    v = torch.randn(bh, tk, d, device=dev, generator=g).to(dtype)
    gout = torch.randn(bh, tq, d, device=dev, generator=g).to(dtype)
    opts = dict(causal=causal, window=window)
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    out, lse = fa.flash_fwd_cuda(q, k, v, **opts)
    r_out, r_lse = fa.flash_fwd_plain(q, k, v, **opts)
    delta = (gout.float() * r_out.float()).sum(-1, keepdim=True)
    got = (fa.flash_dq_cuda(q, k, v, gout, r_lse, delta, **opts),
           *fa.flash_dkv_cuda(q, k, v, gout, r_lse, delta, **opts))
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == tuple(n + 1 for n in before)
    ref = (fa.flash_dq_plain(q, k, v, gout, r_lse, delta, **opts),
           *fa.flash_dkv_plain(q, k, v, gout, r_lse, delta, **opts))
    rtol = 2**-7 if dtype == torch.bfloat16 else 1e-4
    assert out.dtype == dtype and lse.shape == (bh, tq, 1)
    _max_close(out, r_out, rtol)
    torch.testing.assert_close(lse, r_lse, rtol=1e-5, atol=1e-5)
    for x, r in zip(got, ref):
        assert x.dtype == dtype and x.shape == r.shape
        _max_close(x, r, rtol, floor=FLASH_GRAD_FLOOR)


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
        (torch.bfloat16, 4, 5504, 2048),  # its down projection: a K tail past 512 packed rows
        (torch.bfloat16, 1, 2048, 200),  # an out that fits no 32-channel strip
        (torch.bfloat16, 64, 100, 130),  # the most rows the kernel takes, a ragged d
        (torch.float32, 3, 128, 384),  # tiny's widths in fp32
        (torch.float32, 7, 64, 33),  # out % 4 != 0: byte loads
    ],
)
def test_q4_matmul_kernel_matches_plain(dev, dtype, b, d, out):
    """Row 14 against its plain version: bf16 to one bf16 step plus 1e-4 of
    the largest magnitude (fp32 sums of exact products in another order, one
    rounding); fp32 to 1e-4 relative plus the same absolute term. Every
    output is written (its memory held NaN before the call)."""
    g = torch.Generator(device=dev).manual_seed(b * d + out)
    x, p, s = _q4_problem(g, dev, b, d, out, dtype)
    before = q4m.launches
    junk = torch.full((b * out * 4,), float("nan"), device=dev)
    del junk  # the allocator hands this block to y: an unwritten element shows
    y = q4m.q4_matmul_cuda(x, p, s)
    assert q4m.launches == before + 1
    ref = q4m.q4_matmul_torch(x, p, s)
    assert y.dtype == dtype and y.shape == (b, out) and bool(torch.isfinite(y.float()).all())
    _max_close(y, ref, 2**-7 if dtype == torch.bfloat16 else 1e-4)


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
