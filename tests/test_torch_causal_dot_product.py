"""The port's public op ``orion_tpu_torch.ops.causal_dot_product`` held
against the JAX package's ``causal_dot_product_pallas`` (interpret mode).

The same inputs, made with numpy from a seed, go through

- the JAX Pallas kernels ``_cdp_flat`` (row 2) and ``_cdp_rev_flat`` (row 5)
  in interpret mode, against the port's plain versions of its CUDA kernels
  (``causal_dot_plain``, ``causal_dot_rev_plain``);
- ``causal_dot_product_pallas(..., interpret=True)`` and its ``jax.vjp``,
  against ``causal_dot_product(backend="torch")`` (the plain chunked form,
  differentiated by autograd) and against ``CausalDotProductFn`` with its two
  kernel wrappers monkeypatched to their plain versions, since this machine
  has no card.

The JAX side walks chunks of 32, the port's of 64, so the two sum the same
products in other orders. Tolerances: fp32 rtol 1e-5 with atol 1e-5 of the
largest |ref| (sums of a few hundred terms in another order stay near 1e-6
of the largest term); bf16 one bf16 step of |ref| (2^-7: both sum exact
products in fp32 and round once, so a value lands on the reference's bf16
neighbour at worst) plus 1e-3 of the largest |ref| (a gradient passes
through a bf16 rounding of g and of dq's dq pass on both sides, each of
which may land on neighbours where its fp32 sums differ).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.pallas.causal_dot import (
    _cdp_flat,
    _cdp_rev_flat,
    causal_dot_product_pallas,
)
from orion_tpu_torch.ops import causal_dot_product
from orion_tpu_torch.ops.kernels import causal_dot

torch.set_num_threads(2)
_JAX_CHUNK = 32
_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0**-7, 1e-3)}  # (rtol, atol of max|ref|)


def _elu1(x):
    return np.where(x > 0, x + 1.0, np.exp(np.minimum(x, 0.0))).astype(np.float32)


def _close(got, ref, name, dtype="float32"):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        jnp.asarray(got, jnp.float32))
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    rtol, atol = _TOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * float(np.abs(ref).max()),
                               err_msg=name)


def _draw(seed, batch, t, dk, dv):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return {
        "q": _elu1(f(*batch, t, dk)), "k": _elu1(f(*batch, t, dk)), "v": f(*batch, t, dv),
        "g": f(*batch, t, dv), "s0": f(*batch, dk, dv), "gsf": f(*batch, dk, dv),
    }


def _pad(x, t_pad):
    return np.pad(x, [(0, 0), (0, t_pad - x.shape[1]), (0, 0)])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("t,state", [(128, True), (96, False), (130, True), (1, True)])
def test_forward_plain_matches_pallas_kernel(t, state):
    bh, dk, dv = 3, 16, 24
    a = _draw(t, (bh,), t, dk, dv)
    t_pad = -(-t // _JAX_CHUNK) * _JAX_CHUNK
    s0 = a["s0"] if state else np.zeros((bh, dk, dv), np.float32)
    out_r, sf_r = _cdp_flat(*(jnp.asarray(_pad(a[n], t_pad)) for n in ("q", "k", "v")),
                            jnp.asarray(s0), _JAX_CHUNK, True)
    out, sf = causal_dot.causal_dot_plain(
        _t(a["q"]), _t(a["k"]), _t(a["v"]), _t(a["s0"]) if state else None)
    _close(out, out_r[:, :t], "out")
    _close(sf, sf_r, "S")


@pytest.mark.parametrize("t,seeded", [(128, True), (96, False), (130, True), (1, True)])
def test_reverse_plain_matches_pallas_kernel(t, seeded):
    bh, dk, dv = 3, 16, 24
    a = _draw(t + 1, (bh,), t, dk, dv)
    t_pad = -(-t // _JAX_CHUNK) * _JAX_CHUNK
    gsf = a["gsf"] if seeded else np.zeros((bh, dk, dv), np.float32)
    dk_r, dv_r, ds0_r = _cdp_rev_flat(
        *(jnp.asarray(_pad(a[n], t_pad)) for n in ("q", "k", "v", "g")),
        jnp.asarray(np.swapaxes(gsf, 1, 2)), _JAX_CHUNK, True)
    dk_, dv_, ds0 = causal_dot.causal_dot_rev_plain(
        *(_t(a[n]) for n in ("q", "k", "v", "g")), _t(a["gsf"]) if seeded else None)
    assert dk_.dtype == dv_.dtype == ds0.dtype == torch.float32
    _close(dk_, dk_r[:, :t], "dk")
    _close(dv_, dv_r[:, :t], "dv")
    _close(ds0, ds0_r, "dS0")


def _jax_op(a, dtype, with_state, return_state):
    """Outputs and ``jax.vjp`` gradients of the JAX public op (interpret)."""
    jdt = jnp.dtype(dtype)
    args = [jnp.asarray(a[n], jdt) for n in ("q", "k", "v")]
    if with_state:
        args.append(jnp.asarray(a["s0"]))

    def f(q, k, v, *s0):
        return causal_dot_product_pallas(
            q, k, v, chunk=_JAX_CHUNK, return_state=return_state,
            initial_state=s0[0] if s0 else None, interpret=True)

    res, vjp = jax.vjp(f, *args)
    g = jnp.asarray(a["g"], jdt)
    grads = vjp((g, jnp.asarray(a["gsf"])) if return_state else g)
    return res, grads


def _torch_op(a, dtype, with_state, return_state, backend):
    tdt = getattr(torch, dtype)
    args = [_t(a[n]).to(tdt).requires_grad_() for n in ("q", "k", "v")]
    s0 = _t(a["s0"]).requires_grad_() if with_state else None
    res = causal_dot_product(*args, backend=backend, return_state=return_state,
                             initial_state=s0)
    out = res[0] if return_state else res
    loss = (out.float() * _t(a["g"]).to(tdt).float()).sum()
    if return_state:
        loss = loss + (res[1] * _t(a["gsf"])).sum()
    loss.backward()
    grads = [x.grad for x in args] + ([s0.grad] if with_state else [])
    return res, grads


_OP_CASES = [  # (t, batch dims, initial state, return state, dtype)
    (128, (2, 2), True, True, "float32"),
    (96, (3,), False, False, "float32"),
    (130, (2, 2), False, True, "float32"),
    (130, (3,), True, False, "float32"),
    (1, (2, 2), True, True, "float32"),
    (96, (2, 2), True, True, "bfloat16"),
    (130, (3,), False, False, "bfloat16"),
]


@functools.lru_cache(maxsize=None)
def _case(t, batch, with_state, return_state, dtype):
    """One case's inputs and the JAX op's outputs and gradients, shared by
    the two backends' tests."""
    a = _draw(t + 2, batch, t, 16, 24)
    return a, _jax_op(a, dtype, with_state, return_state)


def _check_op(case, backend):
    a, (ref, ref_grads) = _case(*case)
    _, _, with_state, return_state, dtype = case
    got, grads = _torch_op(a, dtype, with_state, return_state, backend)
    if return_state:
        (out, sf), (out_r, sf_r) = got, ref
        assert sf.dtype == torch.float32
        _close(sf, sf_r, "S")
    else:
        out, out_r = got, ref
    assert out.dtype == getattr(torch, dtype) and out.shape == out_r.shape
    _close(out, out_r, "out", dtype)
    for name, x, r in zip(("dq", "dk", "dv", "dS0"), grads, ref_grads):
        assert x.dtype == (torch.float32 if name == "dS0" else getattr(torch, dtype)), name
        _close(x, r, name, dtype)


@pytest.mark.parametrize("t,batch,with_state,return_state,dtype", _OP_CASES)
def test_op_torch_backend_matches_pallas_and_its_vjp(t, batch, with_state, return_state, dtype):
    _check_op((t, batch, with_state, return_state, dtype), "torch")


@pytest.fixture
def plain_kernels(monkeypatch):
    """Stand the plain versions in for the two kernel wrappers, counting the
    calls the way the wrappers count launches."""
    calls = {"fwd": 0, "rev": 0}

    def wrap(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f

    def plain_fwd(q, k, v, s0=None, *, with_state=True):
        out, sf = causal_dot.causal_dot_plain(q, k, v, s0)
        return out, sf if with_state else None

    monkeypatch.setattr(causal_dot, "causal_dot_cuda", wrap("fwd", plain_fwd))
    monkeypatch.setattr(causal_dot, "causal_dot_rev_cuda",
                        wrap("rev", causal_dot.causal_dot_rev_plain))
    return calls


@pytest.mark.parametrize("t,batch,with_state,return_state,dtype", _OP_CASES)
def test_causal_dot_product_fn_matches_pallas_and_its_vjp(
        plain_kernels, t, batch, with_state, return_state, dtype):
    _check_op((t, batch, with_state, return_state, dtype), "cuda")
    # one forward + backward: the forward kernel twice (forward, dq pass),
    # the reverse pass once, also when the state got no cotangent
    assert plain_kernels == {"fwd": 2, "rev": 1}


def test_fn_without_an_out_cotangent_and_without_grad(plain_kernels):
    """Only the state used: g is zeros, the reverse pass still runs and
    dk, dv come from dSf alone; under no_grad the bare forward runs once."""
    a = _draw(5, (2,), 40, 8, 8)
    q, k, v = (_t(a[n]).requires_grad_() for n in ("q", "k", "v"))
    _, sf = causal_dot_product(q, k, v, backend="cuda", return_state=True)
    (sf * _t(a["gsf"])).sum().backward()
    assert plain_kernels == {"fwd": 2, "rev": 1}
    assert float(q.grad.abs().max()) == 0.0  # S does not depend on q
    qr, kr, vr = (_t(a[n]).requires_grad_() for n in ("q", "k", "v"))
    (kr.transpose(-1, -2) @ vr * _t(a["gsf"])).sum().backward()
    _close(k.grad, kr.grad, "dk")
    _close(v.grad, vr.grad, "dv")
    with torch.no_grad():
        out = causal_dot_product(_t(a["q"]), _t(a["k"]), _t(a["v"]), backend="cuda")
    assert plain_kernels["fwd"] == 3 and out.shape == (2, 40, 8)


def test_public_op_names_and_submodules():
    import orion_tpu_torch.ops as ops
    from orion_tpu_torch.ops import linear_attention, softmax_attention

    assert ops.causal_dot_product is causal_dot_product
    assert linear_attention.__name__ == "orion_tpu_torch.ops.linear_attention"
    assert softmax_attention.__name__ == "orion_tpu_torch.ops.softmax_attention"
    q = torch.rand(1, 3, 4)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        causal_dot.causal_dot_cuda(q, q, q)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        causal_dot_product(q, q, q, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        causal_dot_product(q, q, q, backend="xla")
