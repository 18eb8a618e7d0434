"""Why the wgmma linear-attention backward splits A and St into two bf16 halves.

The TPU kernels (``orion_tpu/ops/pallas/causal_dot.py``: ``_bwd_dq_den_kernel``
and ``_bwd_rev_core``) keep the masked chunk scores A and the carried state
(S^T for dq, R for dk, R^T for dv) in fp32 for their products ``A @ w`` and
``x @ St``. A ``wgmma`` takes bf16 operands, so the card's wgmma kernels
(``csrc/causal_dot_bwd.cu``: ``causal_dot_dq_den_wgmma_kernel``,
``causal_dot_rev_den_wgmma_kernel``) run each of them twice, on hi = bf16(x)
and lo = bf16(x - hi), into one fp32 accumulator; A = x y^T and St += y^T w
take bf16 inputs whose products are exact in fp32. This file emulates that
chunk walk in its three roles in plain torch on the CPU (bh 4, a ragged T
1000 of 64-token chunks, dk and dv walking last chunk first, Dk = Dv = 128,
bf16 inputs made with numpy from a seed, without a state and with an initial
state and cotangents (gsf, gzf) of the final one): fp32 matmuls of the bf16
halves give what the tensor cores sum, up to the order of the sums. It holds
dq, dk, dv, dS0 and dz0 against ``causal_dot_dq_den_plain`` /
``causal_dot_rev_den_plain`` and against the JAX package's fused backward
(``jax.vjp`` of ``linear_attention_pallas_fused`` with ``interpret=True``,
as ``tests/test_fused_linear_attention.py`` runs it; the emulation then takes
the JAX forward's own num and den through the quotient rule) within
``chip_smoke.py``'s limits for the card (dq, dk, dv: 1e-4 max|ref| + 2^-7
|ref| a element; dS0, dz0: 1e-4 of their largest magnitude), and shows what
each half buys: the split meets the limits at 0.74-0.95 of them; A rounded
once misses dq's (7.6x with a state, 11x without), St rounded once misses
dq's and dk's (3.6-22x) and, with a state, dv's (13x).

The public op's raw reverse pass (row 5: ``_bwd_rev_kernel``, the same walk
in its dk and dv roles without the denominator, seeded by R = dSf^T, fp32
dk, dv and dS0) runs on the card as ``causal_dot_rev_raw_wgmma_kernel``,
with the same halves. Its outputs are fp32 and held at ``chip_smoke.py``'s
fp32 limits (1e-4 |ref| + 1e-4 max|ref|; dS0 1e-4 of its largest
magnitude), 2^7 tighter than rows 3-4's, and R starts from dSf = 8 randn,
which bf16 does not represent. The ``test_raw_*`` tests emulate it (bh 4, a
ragged T 200, Dk = Dv = 128, with and without dSf) against
``causal_dot_rev_plain`` and against the JAX package's ``_cdp_rev_flat`` in
interpret mode: two halves meet the limits at 0.01-0.03 of them; A rounded
once misses them 6.6-11x, R rounded once 2.2-15x (dv's least).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orion_tpu.ops.pallas.causal_dot import (
    _cdp_rev_flat,
    _cdpn_flat,
    linear_attention_pallas_fused,
)
from orion_tpu_torch.ops.kernels import causal_dot as cd

BH, T, D, C, EPS = 4, 1000, 128, 64, 1e-6
GRADS = ("dq", "dk", "dv")


def _inputs(with_state):
    """q, k phi-mapped, v and the output's cotangent, bf16 [BH, T, D]; with
    ``with_state`` also the state a 256-token prefix leaves and cotangents of
    the final state at the scale of what the walk accumulates (chip_smoke's
    training cases)."""
    rng = np.random.default_rng(21 + with_state)

    def normal(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    def phi(shape):
        return torch.nn.functional.elu(normal(shape)) + 1.0

    q, k = phi((BH, T, D)).bfloat16(), phi((BH, T, D)).bfloat16()
    v, gout = normal((BH, T, D)).bfloat16(), normal((BH, T, D)).bfloat16()
    s0 = z0 = gsf = gzf = None
    if with_state:
        kp = phi((BH, 256, D)).bfloat16().float()
        vp = normal((BH, 256, D)).bfloat16().float()
        s0, z0 = kp.transpose(1, 2) @ vp, kp.sum(1)
        gsf, gzf = 0.05 * normal((BH, D, D)), 0.05 * normal((BH, D))
    return q, k, v, gout, s0, z0, gsf, gzf


def _halves(x, split):
    """x as the wgmma operands the kernel feeds: [hi, lo], or [bf16(x)]."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if split else [hi]


def _walk(role, x, y, w, st, gd, z, split_a, split_s, out_dtype=torch.bfloat16):
    """One role of the wgmma kernels' chunk walk on [BH, T, .] operands:
    per 64-token chunk (dq first to last, dk and dv last to first) A = x y^T
    plus gden_t (dq) or gden_s (dk), masked to s <= t (dq) or s >= t by a
    select; out = A w + x St on the halves of A and of St, plus gden_t z
    (dq) or zr (dk); then St += y^T w and z += the chunk's sums of w (dq) or
    of gden_s w_s (dk). Without ``gd`` (the raw reverse pass) no gden and no
    z. -> (out in ``out_dtype``, the final St, the final z)."""
    t = x.shape[1]
    n = -(-t // C)

    def pad(a):
        return torch.nn.functional.pad(a, (0, 0, 0, n * C - t) if a.dim() == 3 else (0, n * C - t))

    x, y, w = (pad(a.float()) for a in (x, y, w))
    gd = pad(gd) if gd is not None else None
    keep = torch.ones(C, C, dtype=torch.bool)
    keep = keep.tril() if role == "dq" else keep.triu()
    den = gd is not None and role != "dv"
    out = torch.zeros(x.shape[0], n * C, w.shape[-1])
    for c in range(n) if role == "dq" else reversed(range(n)):
        sl = slice(c * C, (c + 1) * C)
        xc, yc, wc = x[:, sl], y[:, sl], w[:, sl]
        a = xc @ yc.transpose(1, 2)
        if den:
            a = a + (gd[:, sl, None] if role == "dq" else gd[:, None, sl])
        a = torch.where(keep, a, 0.0)
        o = sum(h @ wc for h in _halves(a, split_a)) + sum(xc @ h for h in _halves(st, split_s))
        if den and role == "dq":
            o, z = o + gd[:, sl, None] * z[:, None, :], z + wc.sum(1)
        elif den:
            o, z = o + z[:, None, :], z + (gd[:, sl, None] * wc).sum(1)
        out[:, sl] = o
        st = st + yc.transpose(1, 2) @ wc
    return out[:, :t].to(out_dtype), st, z


def _emulate(q, k, v, g, gden, s0, z0, gsf, gzf, split_a=True, split_s=True):
    """The two wgmma kernels on one layer's backward -> (dq, dk, dv, dS0,
    dz0): dq (x = g, y = v, w = k, St = S0^T), dk (x = v, y = g, w = q,
    St = R = gsf^T, zr = gzf), dv (x = k, y = q, w = g, St = R^T = gsf)."""
    halves = dict(split_a=split_a, split_s=split_s)
    zeros = torch.zeros(BH, D, D)
    s0t = zeros if s0 is None else s0.transpose(1, 2)
    dq, _, _ = _walk("dq", g, v, k, s0t, gden, torch.zeros(BH, D) if z0 is None else z0, **halves)
    r = zeros if gsf is None else gsf.transpose(1, 2)
    dk, _, dz0 = _walk("dk", v, g, q, r, gden, torch.zeros(BH, D) if gzf is None else gzf,
                       **halves)
    dv, ds0, _ = _walk("dv", k, q, g, zeros if gsf is None else gsf, None, None, **halves)
    return dq, dk, dv, ds0, dz0


def _reading(got, ref):
    """dq, dk, dv's largest error as a share of its card limit
    (``chip_smoke._grad_reading``), dS0 and dz0's relative error as a share
    of ``STATE_RTOL``: above 1 misses."""
    r = {n: chip_smoke._grad_reading(a, b)["over_limit"] for n, a, b in zip(GRADS, got, ref)}
    r.update({n: chip_smoke._rel(a, b) / chip_smoke.STATE_RTOL
              for n, a, b in zip(("dS0", "dz0"), got[3:], ref[3:])})
    return r


@pytest.fixture(scope="module", params=[False, True], ids=["no state", "state and gsf, gzf"])
def case(request):
    """(q, k, v, gnum, gden, s0, z0, gsf, gzf) from the plain forward's num and
    den through the quotient rule, and the plain backward on them."""
    q, k, v, gout, s0, z0, gsf, gzf = _inputs(request.param)
    _, _, _, num, den = cd.causal_dot_norm_plain(q, k, v, s0, z0, eps=EPS, with_parts=True)
    g, gden = cd.quotient_rule(gout, num, den, EPS, q.dtype)
    ref = (cd.causal_dot_dq_den_plain(g, v, k, gden, s0, z0),
           *cd.causal_dot_rev_den_plain(q, k, v, g, gden, gsf, gzf))
    return (q, k, v, g, gden, s0, z0, gsf, gzf), ref, (gout, request.param)


def test_the_split_meets_the_card_limits(case):
    args, ref, _ = case
    r = _reading(_emulate(*args), ref)
    assert max(r.values()) <= 1.0, r


def test_the_split_matches_the_jax_fused_backward(case):
    """The emulated walk against ``jax.vjp`` of the JAX package's fused
    linear attention in interpret mode (T padded to whole chunks with zeros,
    as ``_prep_fused`` pads; a zero state and zero cotangents stand for none),
    fed the JAX forward's own num and den (``_cdpn_flat``) through the
    quotient rule, so both walk on the same bf16 g."""
    (q, k, v, _, _, s0, z0, gsf, gzf), _, (gout, _) = case

    def jx(x):
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)

    def f32(x, shape):
        return jnp.zeros(shape, jnp.float32) if x is None else jnp.asarray(x.numpy())

    js0, jz0 = f32(s0, (BH, D, D)), f32(z0, (BH, D))

    def fused(q, k, v, s0, z0):
        return linear_attention_pallas_fused(q, k, v, chunk=C, eps=EPS, initial_state=(s0, z0),
                                             return_state=True, interpret=True)

    (_, (sf, zf)), vjp = jax.vjp(fused, jx(q), jx(k), jx(v), js0, jz0)
    grads = vjp((jx(gout), (f32(gsf, sf.shape), f32(gzf, zf.shape))))
    ref = [torch.from_numpy(np.array(x.astype(jnp.float32))) for x in grads]
    ref = [x.bfloat16() for x in ref[:3]] + ref[3:]

    def padded(x):
        return jnp.pad(jx(x), ((0, 0), (0, C * -(-T // C) - T), (0, 0)))

    num, den, _, _ = _cdpn_flat(padded(q), padded(k), padded(v), js0, jz0[:, None], C, True)
    num = torch.from_numpy(np.array(num))[:, :T]
    den = torch.from_numpy(np.array(den))[:, :T, 0]
    g, gden = cd.quotient_rule(gout, num, den, EPS, q.dtype)
    r = _reading(_emulate(q, k, v, g, gden, s0, z0, gsf, gzf), ref)
    assert max(r.values()) <= 1.0, r


def test_rounding_a_once_misses_the_dq_limit(case):
    args, ref, _ = case
    r = _reading(_emulate(*args, split_a=False), ref)
    assert r["dq"] > 1.0, r


def test_rounding_st_once_misses_the_limits(case):
    """St carried once in bf16: dq's and dk's limits are missed from a zero
    state already (St sums g (x) q and v (x) k over the chunks behind), dv's
    with a state."""
    args, ref, (_, with_state) = case
    r = _reading(_emulate(*args, split_s=False), ref)
    missed = GRADS if with_state else ("dq", "dk")
    assert all(r[n] > 1.0 for n in missed), r


# ---------------------------------------------------------------------------
# Row 5: the public op's raw reverse pass
# ---------------------------------------------------------------------------

RAW_T = 200  # a ragged last chunk of 8 tokens, walked first


def _emulate_raw(q, k, v, g, gsf, split_a=True, split_s=True):
    """``causal_dot_rev_raw_wgmma_kernel`` on [BH, T, 128] operands -> fp32
    (dk, dv, dS0): dk (x = v, y = g, w = q, St = R = gsf^T) and dv (x = k,
    y = q, w = g, St = R^T = gsf, its final St dS0), zeros for no gsf."""
    halves = dict(split_a=split_a, split_s=split_s, out_dtype=torch.float32)
    r = torch.zeros(q.shape[0], D, D) if gsf is None else gsf
    dk, _, _ = _walk("dk", v, g, q, r.transpose(1, 2), None, None, **halves)
    dv, ds0, _ = _walk("dv", k, q, g, r, None, None, **halves)
    return dk, dv, ds0


def _raw_reading(got, ref):
    """dk and dv's largest error as a share of chip_smoke's fp32 RAW limit
    (1e-4 |ref| + 1e-4 max|ref|), dS0's relative error as a share of
    ``STATE_RTOL``: above 1 misses."""
    lim = dict(rtol=chip_smoke.RAW_RTOL[torch.float32], atol_of_max=chip_smoke.RAW_ATOL_OF_MAX)
    r = {n: chip_smoke._grad_reading(a, b, **lim)["over_limit"]
         for n, a, b in zip(("dk", "dv"), got, ref)}
    r["dS0"] = chip_smoke._rel(got[2], ref[2]) / chip_smoke.STATE_RTOL
    return r


@pytest.fixture(scope="module", params=[False, True], ids=["no dSf", "dSf 8 randn"])
def raw_case(request):
    """(q, k, v, g, gsf) in bf16 (gsf fp32 or None) as chip_smoke's RAW
    cases draw them (g the op's output cotangent; dSf at the scale of what
    the walk itself sums), and ``causal_dot_rev_plain`` on them."""
    rng = np.random.default_rng(31 + request.param)

    def normal(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    q, k = ((torch.nn.functional.elu(normal((BH, RAW_T, D))) + 1.0).bfloat16() for _ in range(2))
    v, g = (normal((BH, RAW_T, D)).bfloat16() for _ in range(2))
    gsf = 8.0 * normal((BH, D, D)) if request.param else None
    return (q, k, v, g, gsf), cd.causal_dot_rev_plain(q, k, v, g, gsf)


def test_raw_split_meets_the_card_limits(raw_case):
    args, ref = raw_case
    r = _raw_reading(_emulate_raw(*args), ref)
    assert max(r.values()) <= 1.0, r


def test_raw_split_matches_the_jax_reverse_pass(raw_case):
    """The emulated walk against the JAX package's ``_cdp_rev_flat`` in
    interpret mode (T padded to whole chunks with zeros; R seeded by dSf^T,
    zeros for none), as ``tests/test_torch_causal_dot_product.py`` runs it."""
    (q, k, v, g, gsf), _ = raw_case
    t_pad = C * -(-RAW_T // C)

    def padded(x):
        return jnp.pad(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                       ((0, 0), (0, t_pad - RAW_T), (0, 0)))

    rinit = np.zeros((BH, D, D), np.float32) if gsf is None else gsf.transpose(1, 2).numpy()
    ref = _cdp_rev_flat(padded(q), padded(k), padded(v), padded(g), jnp.asarray(rinit), C, True)
    ref = [torch.from_numpy(np.array(x)) for x in ref]
    r = _raw_reading(_emulate_raw(q, k, v, g, gsf), (ref[0][:, :RAW_T], ref[1][:, :RAW_T], ref[2]))
    assert max(r.values()) <= 1.0, r


def test_raw_rounding_a_once_misses_the_limits(raw_case):
    """A = v g^T (dk) or k q^T (dv) fed once in bf16: both dk and dv miss."""
    args, ref = raw_case
    r = _raw_reading(_emulate_raw(*args, split_a=False), ref)
    assert r["dk"] > 1.0 and r["dv"] > 1.0, r


def test_raw_rounding_r_once_misses_the_limits(raw_case):
    """R (dk) and R^T (dv) fed once in bf16: both miss, from dSf and from
    the g (x) q sums of the chunks behind alone."""
    args, ref = raw_case
    r = _raw_reading(_emulate_raw(*args, split_s=False), ref)
    assert r["dk"] > 1.0 and r["dv"] > 1.0, r
