"""The raw fused parts of rows 1, 3 and 4 (``linear_attention_parts``) held
against the JAX package's ``linear_attention_pallas_parts``, on the CPU.

Sequence-parallel linear attention consumes the fused pass's raw fp32
parts: the numerator, the denominator and the final (S, z)
(``orion_tpu/parallel/sequence.py``). The same numpy-drawn feature-mapped
inputs go through the JAX function (its kernels in interpret mode) and the
port's plain version (its CPU path), with and without an initial state, at
an even and a ragged length; gradients for cotangents on all four outputs
(and on the initial state) through ``jax.vjp`` and autograd. Then
``LinearAttentionPartsFn`` with the plain versions standing in for its
three kernels (this machine has no card): its glue (the numerator's
cotangent cast to the input dtype, the denominator's in fp32, the state's
cotangents) against the same reference. Tolerance 1e-5 relative and
absolute at fp32 (sums of exact products in another order, as
``tests/test_torch_linear_attention.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.pallas.causal_dot import linear_attention_pallas_parts
from orion_tpu_torch.ops.kernels import causal_dot as cd

torch.set_num_threads(2)
_TOL = dict(atol=1e-5, rtol=1e-5)
CHUNK = 8


def _inputs(seed, t, with_state, dk=8, dv=8):
    rng = np.random.default_rng(seed)
    # positive features, as a feature map gives them (den stays away from 0)
    q, k = (np.abs(rng.standard_normal((2, 2, t, dk), dtype=np.float32)) + 0.1 for _ in range(2))
    v = rng.standard_normal((2, 2, t, dv), dtype=np.float32)
    state = None
    if with_state:
        state = (rng.standard_normal((2, 2, dk, dv), dtype=np.float32),
                 np.abs(rng.standard_normal((2, 2, dk), dtype=np.float32)) + 1.0)
    cts = [rng.standard_normal(s, dtype=np.float32)
           for s in ((2, 2, t, dv), (2, 2, t), (2, 2, dk, dv), (2, 2, dk))]
    return q, k, v, state, cts


def _jax_side(q, k, v, state, cts):
    args = [jnp.asarray(x) for x in (q, k, v)]
    if state is not None:
        args.append(tuple(jnp.asarray(s) for s in state))

    def fn(*a):
        st = a[3] if len(a) > 3 else None
        num, den, (s, z) = linear_attention_pallas_parts(a[0], a[1], a[2], chunk=CHUNK,
                                                         initial_state=st, interpret=True)
        return num, den, s, z

    outs, vjp = jax.vjp(fn, *args)
    grads = vjp(tuple(jnp.asarray(c) for c in cts))
    flat = list(grads[:3]) + (list(grads[3]) if state is not None else [])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in flat]


def _port_side(q, k, v, state, cts, backend):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    st = None
    if state is not None:
        st = tuple(torch.from_numpy(s).requires_grad_() for s in state)
        leaves += list(st)
    num, den, (s, z) = cd.linear_attention_parts(*leaves[:3], chunk=CHUNK, initial_state=st,
                                                 backend=backend)
    sum(((o * torch.from_numpy(c)).sum() for o, c in zip((num, den, s, z), cts))).backward()
    return [x.detach().numpy() for x in (num, den, s, z)], [x.grad.numpy() for x in leaves]


CASES = [(t, st) for t in (32, 29) for st in (False, True)]


@pytest.mark.parametrize("t,with_state", CASES)
def test_plain_parts_match_the_jax_parts(t, with_state):
    q, k, v, state, cts = _inputs(t + with_state, t, with_state)
    r_outs, r_grads = _jax_side(q, k, v, state, cts)
    outs, grads = _port_side(q, k, v, state, cts, "torch")
    for got, ref, name in zip(outs, r_outs, ("num", "den", "S", "z")):
        np.testing.assert_allclose(got, ref, **_TOL, err_msg=name)
    for got, ref, name in zip(grads, r_grads, ("dq", "dk", "dv", "dS0", "dz0")):
        np.testing.assert_allclose(got, ref, **_TOL, err_msg=name)


@pytest.mark.parametrize("t,with_state", CASES)
def test_parts_fn_glue_matches_the_jax_parts(t, with_state, monkeypatch):
    """The kernel route's autograd Function, its three kernels stood in for
    by their plain versions."""
    monkeypatch.setattr(cd, "causal_dot_norm_cuda",
                        lambda *a, **kw: cd.causal_dot_norm_plain(*a, chunk=64, **kw))
    monkeypatch.setattr(cd, "causal_dot_dq_den_cuda", cd.causal_dot_dq_den_plain)
    monkeypatch.setattr(cd, "causal_dot_rev_den_cuda", cd.causal_dot_rev_den_plain)
    q, k, v, state, cts = _inputs(t * 3 + with_state, t, with_state)
    r_outs, r_grads = _jax_side(q, k, v, state, cts)
    outs, grads = _port_side(q, k, v, state, cts, "cuda")
    for got, ref, name in zip(outs, r_outs, ("num", "den", "S", "z")):
        np.testing.assert_allclose(got, ref, **_TOL, err_msg=name)
    for got, ref, name in zip(grads, r_grads, ("dq", "dk", "dv", "dS0", "dz0")):
        np.testing.assert_allclose(got, ref, **_TOL, err_msg=name)


def test_parts_without_grad_take_the_forward_kernel_alone(monkeypatch):
    """No gradient wanted: one forward launch and no Function (the wrapper
    counted here is a stand-in)."""
    calls = []

    def forward(*a, **kw):
        calls.append(kw)
        return cd.causal_dot_norm_plain(*a, **kw)

    monkeypatch.setattr(cd, "causal_dot_norm_cuda", forward)
    q, k, v, _, _ = _inputs(0, 16, False)
    with torch.no_grad():
        num, den, (s, z) = cd.linear_attention_parts(*(torch.from_numpy(x) for x in (q, k, v)),
                                                     backend="cuda")
    assert calls == [{"with_parts": True}]
    assert num.dtype == den.dtype == s.dtype == z.dtype == torch.float32
    assert num.shape == (2, 2, 16, 8) and den.shape == (2, 2, 16) and s.shape == (2, 2, 8, 8)
