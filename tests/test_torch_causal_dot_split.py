"""Why the wgmma linear-attention forward splits A and S into two bf16 halves.

The TPU kernel (``orion_tpu/ops/pallas/causal_dot.py::_kernel_norm``) keeps
the masked chunk scores A = q k^T and the carried state S in fp32 for its
products ``A @ v`` and ``q @ S``. A ``wgmma`` takes bf16 operands, so the
card's wgmma kernel (``csrc/causal_dot_norm.cu``,
``causal_dot_norm_wgmma_kernel``) runs each of them twice, on hi = bf16(x)
and lo = bf16(x - hi), into one fp32 accumulator; A = q k^T, S += k^T v and
the denominator's sums take bf16 inputs whose products are exact in fp32.
This file emulates that chunk walk in plain torch on the CPU (bh 4, a
ragged T 1000 of 64-token chunks, Dk = Dv = 128, bf16 inputs made with
numpy from a seed, with and without the state a 256-token prefix leaves):
fp32 matmuls of the bf16 halves give what the tensor cores sum, up to the
order of the sums. It holds out, num, den, S and z against
``causal_dot_norm_plain`` and against the JAX package's fused kernel
(``_lin_attn_fused`` with ``interpret=True``, as
``tests/test_fused_linear_attention.py`` runs it) within ``chip_smoke.py``'s
limits for the card (out: 1e-4 + 2^-7 |ref| a element; num, den, S, z: 1e-4
of their largest magnitude), and shows what each half buys: A rounded once
misses out's limit (1.1x with a state, 18x without), S rounded once meets
it (0.90-0.94 of it, against 0.76-0.93 for the split) but misses num's, the
residual the backward takes (4.0-5.8e-4 against 1e-4).

The raw walk of the public op (row 2, ``causal_dot_raw_wgmma_kernel``: the
same walk without z, den and the division, out = A v + q S) is emulated the
same way, as the op's forward on (q, k, v, S0) and as its dq pass on (g, v,
k, S0^T), against ``causal_dot_plain`` and the JAX ``causal_dot_product_pallas``
in interpret mode, within chip_smoke.py's RAW limits (one bf16 step 2^-7
|ref| plus 1e-4 of max|ref| an element; S 1e-4 of its largest magnitude).
It needs both halves: A rounded once misses out's limit in every case, and
so does S rounded once, most in the dq pass (``test_raw_*``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from orion_tpu.ops.pallas.causal_dot import _lin_attn_fused, causal_dot_product_pallas
from orion_tpu_torch.ops.kernels import causal_dot as cd

BH, T, DK, DV, C, EPS = 4, 1000, 128, 128, 64, 1e-6


def _inputs(with_state):
    rng = np.random.default_rng(9 + with_state)

    def phi(shape):
        return torch.nn.functional.elu(torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32))) + 1.0

    q, k = phi((BH, T, DK)).bfloat16(), phi((BH, T, DK)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((BH, T, DV), dtype=np.float32)).bfloat16()
    s0 = z0 = None
    if with_state:  # the state a 256-token prefix leaves
        kp = phi((BH, 256, DK)).bfloat16().float()
        vp = torch.from_numpy(rng.standard_normal((BH, 256, DV), dtype=np.float32)).bfloat16()
        s0, z0 = kp.transpose(1, 2) @ vp.float(), kp.sum(1)
    return q, k, v, s0, z0


def _halves(x, split):
    """x as the wgmma operands the kernel feeds: [hi, lo], or [bf16(x)]."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if split else [hi]


def _emulate(q, k, v, s0, z0, split_a=True, split_s=True):
    """The wgmma kernel's chunk walk: per chunk A = q k^T masked to s <= t,
    den = rowsum A + q . z, num = A v + q S on the halves of A and of S, then
    S += k^T v and z += the chunk's column sums of k; out = num / (den + eps)
    rounded once to bf16. -> (out, S, z, num, den)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.zeros(BH, DK, DV) if s0 is None else s0.clone()
    z = torch.zeros(BH, DK) if z0 is None else z0.clone()
    nums, dens = [], []
    for c0 in range(0, T, C):
        qc, kc, vc = qf[:, c0:c0 + C], kf[:, c0:c0 + C], vf[:, c0:c0 + C]
        a = torch.tril(qc @ kc.transpose(1, 2))
        dens.append(a.sum(-1) + (qc * z[:, None]).sum(-1))
        nums.append(sum(h @ vc for h in _halves(a, split_a))
                    + sum(qc @ h for h in _halves(s, split_s)))
        s = s + kc.transpose(1, 2) @ vc
        z = z + kc.sum(1)
    num, den = torch.cat(nums, 1), torch.cat(dens, 1)
    return (num / (den[..., None] + EPS)).bfloat16(), s, z, num, den


def _reading(got, ref):
    """out's largest error as a share of its card limit, and the largest
    relative error of num, den, S and z (limit ``STATE_RTOL``)."""
    diff, r = (got[0].float() - ref[0].float()).abs(), ref[0].float().abs()
    out = float((diff / (chip_smoke.OUT_ATOL + chip_smoke.OUT_RTOL * r)).max())
    rel = {n: chip_smoke._rel(x, y)
           for n, x, y in zip(("S", "z", "num", "den"), got[1:], ref[1:]) if x is not None}
    return out, rel


@pytest.fixture(scope="module", params=[False, True], ids=["no state", "state"])
def case(request):
    args = _inputs(request.param)
    return args, cd.causal_dot_norm_plain(*args, eps=EPS, with_parts=True)


def test_the_split_meets_the_card_limits(case):
    args, ref = case
    out, rel = _reading(_emulate(*args), ref)
    assert out <= 1.0 and max(rel.values()) <= chip_smoke.STATE_RTOL, (out, rel)


def test_the_split_matches_the_jax_fused_kernel(case):
    """The emulated walk against ``_lin_attn_fused`` in interpret mode (T
    padded to whole chunks with zeros, as ``_prep_fused`` pads): out, S, z
    and den."""
    args, _ = case
    q, k, v, s0, z0 = args
    pad = C * -(-T // C) - T

    def jx(x):
        return jnp.asarray(np.pad(x.float().numpy(), ((0, 0), (0, pad), (0, 0))), jnp.bfloat16)

    js0 = jnp.zeros((BH, DK, DV), jnp.float32) if s0 is None else jnp.asarray(s0.numpy())
    jz0 = jnp.zeros((BH, 1, DK), jnp.float32) if z0 is None else jnp.asarray(z0.numpy())[:, None]
    j_out, j_s, j_z, j_den = _lin_attn_fused(jx(q), jx(k), jx(v), js0, jz0, C, EPS, True)
    ref = (torch.from_numpy(np.array(j_out.astype(jnp.float32))[:, :T]),
           torch.from_numpy(np.array(j_s)), torch.from_numpy(np.array(j_z))[:, 0],
           None, torch.from_numpy(np.array(j_den))[:, :T, 0])
    got = _emulate(*args)
    out, rel = _reading((got[0], got[1], got[2], None, got[4]), ref)
    assert out <= 1.0 and max(rel.values()) <= chip_smoke.STATE_RTOL, (out, rel)


def test_rounding_a_once_misses_the_out_limit(case):
    args, ref = case
    out, _ = _reading(_emulate(*args, split_a=False), ref)
    assert out > 1.0, out


def test_rounding_s_once_misses_the_numerator_limit(case):
    """The numerator is the backward's residual (``with_parts``): S rounded
    once moves it by about 5e-4 of its largest magnitude."""
    args, ref = case
    _, rel = _reading(_emulate(*args, split_s=False), ref)
    assert rel["num"] > chip_smoke.STATE_RTOL, rel


# ---------------------------------------------------------------------------
# Row 2: the raw walk, as the op's forward and as its dq pass
# ---------------------------------------------------------------------------


def _emulate_raw(q, k, v, s0, split_a=True, split_s=True):
    """The raw wgmma kernel's chunk walk: per chunk A = q k^T masked to s <=
    t, out = A v + q S on the halves of A and of S, S += k^T v; out rounded
    once to the input dtype. -> (out, S)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.zeros(qf.shape[0], qf.shape[-1], vf.shape[-1]) if s0 is None else s0.clone()
    outs = []
    for c0 in range(0, qf.shape[1], C):
        qc, kc, vc = qf[:, c0:c0 + C], kf[:, c0:c0 + C], vf[:, c0:c0 + C]
        a = torch.tril(qc @ kc.transpose(1, 2))
        outs.append(sum(h @ vc for h in _halves(a, split_a))
                    + sum(qc @ h for h in _halves(s, split_s)))
        s = s + kc.transpose(1, 2) @ vc
    return torch.cat(outs, 1).to(q.dtype), s


def _raw_reading(got, ref):
    """out's largest error as a share of chip_smoke's RAW limit, and S's
    largest relative error."""
    diff, r = (got[0].float() - ref[0].float()).abs(), ref[0].float().abs()
    limit = chip_smoke.RAW_ATOL_OF_MAX * r.max() + chip_smoke.RAW_RTOL[torch.bfloat16] * r
    return float((diff / limit).max()), chip_smoke._rel(got[1], ref[1])


@pytest.fixture(scope="module", params=[(False, "forward"), (False, "dq pass"), (True, "forward"),
                                        (True, "dq pass")],
                ids=["no state, forward", "no state, dq pass", "state, forward",
                     "state, dq pass"])
def raw_case(request):
    """The op's two calls of row 2 on one set of inputs (bh 4, T 1000, D 128,
    bf16): the forward on (q, k, v, S0), the dq pass on (g, v, k, S0^T)."""
    with_state, role = request.param
    q, k, v, s0, _ = _inputs(with_state)
    g = torch.from_numpy(np.random.default_rng(31 + with_state).standard_normal(
        (BH, T, DV), dtype=np.float32)).bfloat16()
    args = (q, k, v, s0) if role == "forward" else (
        g, v, k, s0.transpose(1, 2).contiguous() if s0 is not None else None)
    return args, cd.causal_dot_plain(*args)


def test_raw_split_meets_the_card_limits(raw_case):
    args, ref = raw_case
    out, s_rel = _raw_reading(_emulate_raw(*args), ref)
    assert out <= 1.0 and s_rel <= chip_smoke.STATE_RTOL, (out, s_rel)


def test_raw_split_matches_the_jax_op(raw_case):
    """The emulated raw walk against the JAX op in interpret mode (chunks of
    64, T padded to whole chunks with zeros): out and S."""
    args, _ = raw_case
    x, y, w, s0 = args
    pad = C * -(-T // C) - T

    def jx(a):
        return jnp.asarray(np.pad(a.float().numpy(), ((0, 0), (0, pad), (0, 0))), jnp.bfloat16)

    j_out, j_s = causal_dot_product_pallas(
        jx(x)[None], jx(y)[None], jx(w)[None], chunk=C, return_state=True,
        initial_state=None if s0 is None else jnp.asarray(s0.numpy())[None], interpret=True)
    ref = (torch.from_numpy(np.array(j_out.astype(jnp.float32))[0, :, :T]),
           torch.from_numpy(np.array(j_s)[0]))
    out, s_rel = _raw_reading(_emulate_raw(*args), ref)
    assert out <= 1.0 and s_rel <= chip_smoke.STATE_RTOL, (out, s_rel)


def test_raw_rounding_a_once_misses_the_out_limit(raw_case):
    args, ref = raw_case
    out, _ = _raw_reading(_emulate_raw(*args, split_a=False), ref)
    assert out > 1.0, out


def test_raw_rounding_s_once_misses_the_out_limit(raw_case):
    """S rounded once: out misses its limit in both calls, most in the dq
    pass, where S0^T and the chunks' v^T k meet g's random signs."""
    args, ref = raw_case
    out, _ = _raw_reading(_emulate_raw(*args, split_s=False), ref)
    assert out > 1.0, out
