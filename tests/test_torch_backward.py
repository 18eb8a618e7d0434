"""The port's linear-attention backward held against the JAX package's.

The same inputs, made with numpy from a seed, go through the JAX Pallas
backward kernels in interpret mode (``_cdp_dq_den_flat``,
``_cdp_rev_den_flat``) and ``jax.vjp`` of ``linear_attention_pallas_fused``,
and through the port's plain versions of its CUDA backward kernels and its
``LinearAttentionFn`` (with the three kernel wrappers monkeypatched to their
plain versions, since this machine has no card).

Tolerances, all fp32: outputs agree to 1e-5 of their largest magnitude plus
1e-5 relative (the two sides sum the same exact products in other orders;
the sums run over at most a few hundred terms, so their rounding stays
near 1e-6 of the largest term).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.pallas.causal_dot import (
    _cdp_dq_den_flat,
    _cdp_rev_den_flat,
    linear_attention_pallas_fused,
)
from orion_tpu_torch.ops import linear_attention as la
from orion_tpu_torch.ops.kernels import causal_dot

torch.set_num_threads(2)
_TOL = 1e-5


def _elu1(x):
    return np.where(x > 0, x + 1.0, np.exp(np.minimum(x, 0.0))).astype(np.float32)


def _close(got, ref, name):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=_TOL, atol=_TOL * float(np.abs(ref).max()),
                               err_msg=name)


def _draw(seed, bh, t, dk, dv):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return {
        "q": _elu1(f(bh, t, dk)), "k": _elu1(f(bh, t, dk)), "v": f(bh, t, dv),
        "g": f(bh, t, dv), "gden": f(bh, t) * 0.1,
        "s0": f(bh, dk, dv), "z0": np.abs(f(bh, dk)) * 4.0,
        "gsf": f(bh, dk, dv) * 0.1, "gzf": f(bh, dk) * 0.1,
    }


def _pad(x, t_pad):
    return np.pad(x, [(0, 0), (0, t_pad - x.shape[1])] + [(0, 0)] * (x.ndim - 2))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("t,state", [(128, True), (128, False), (100, True), (1, False)])
def test_dq_den_plain_matches_pallas(t, state):
    bh, dk, dv, chunk = 3, 16, 24, 32
    a = _draw(t, bh, t, dk, dv)
    tp = -(-t // chunk) * chunk
    s0t = np.swapaxes(a["s0"], 1, 2) if state else np.zeros((bh, dv, dk), np.float32)
    z0 = a["z0"] if state else np.zeros((bh, dk), np.float32)
    ref = _cdp_dq_den_flat(
        jnp.asarray(_pad(a["g"], tp)), jnp.asarray(_pad(a["v"], tp)),
        jnp.asarray(_pad(a["k"], tp)), jnp.asarray(s0t),
        jnp.asarray(_pad(a["gden"], tp)[..., None]), jnp.asarray(z0[:, None, :]),
        chunk, True,
    )[:, :t]
    got = causal_dot.causal_dot_dq_den_plain(
        _t(a["g"]), _t(a["v"]), _t(a["k"]), _t(a["gden"]),
        _t(a["s0"]) if state else None, _t(a["z0"]) if state else None,
    )
    _close(got, ref, "dq")


@pytest.mark.parametrize("t,state", [(128, True), (128, False), (100, True), (1, True)])
def test_rev_den_plain_matches_pallas(t, state):
    bh, dk, dv, chunk = 3, 16, 24, 32
    a = _draw(t + 1, bh, t, dk, dv)
    tp = -(-t // chunk) * chunk
    rinit = np.swapaxes(a["gsf"], 1, 2) if state else np.zeros((bh, dv, dk), np.float32)
    zr0 = a["gzf"] if state else np.zeros((bh, dk), np.float32)
    dk_r, dv_r, ds0_r, dz0_r = _cdp_rev_den_flat(
        *(jnp.asarray(_pad(a[n], tp)) for n in ("q", "k", "v", "g")),
        jnp.asarray(_pad(a["gden"], tp)[..., None]), jnp.asarray(rinit),
        jnp.asarray(zr0[:, None, :]), chunk, True,
    )
    got = causal_dot.causal_dot_rev_den_plain(
        *(_t(a[n]) for n in ("q", "k", "v", "g", "gden")),
        _t(a["gsf"]) if state else None, _t(a["gzf"]) if state else None,
    )
    for name, x, ref in zip(("dk", "dv", "ds0", "dz0"), got,
                            (dk_r[:, :t], dv_r[:, :t], ds0_r, dz0_r[:, 0])):
        _close(x, ref, name)


@pytest.fixture
def plain_kernels(monkeypatch):
    """Stand the plain versions in for the three kernel wrappers, counting
    the calls the way the wrappers count launches."""
    calls = {"fwd": 0, "dq": 0, "rev": 0}

    def wrap(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f

    monkeypatch.setattr(causal_dot, "causal_dot_norm_cuda",
                        wrap("fwd", causal_dot.causal_dot_norm_plain))
    monkeypatch.setattr(causal_dot, "causal_dot_dq_den_cuda",
                        wrap("dq", causal_dot.causal_dot_dq_den_plain))
    monkeypatch.setattr(causal_dot, "causal_dot_rev_den_cuda",
                        wrap("rev", causal_dot.causal_dot_rev_den_plain))
    return calls


@pytest.mark.parametrize("t,state", [(96, True), (77, True), (77, False), (1, True)])
def test_linear_attention_fn_matches_jax_vjp(plain_kernels, t, state):
    bh, dk, dv = 4, 16, 24
    a = _draw(t + 7, bh, t, dk, dv)
    names = ["q", "k", "v"] + (["s0", "z0"] if state else [])

    def f(q, k, v, *st):
        out, (sf, zf) = linear_attention_pallas_fused(
            q, k, v, chunk=32, initial_state=tuple(st) if st else None,
            return_state=True, interpret=True,
        )
        return out, sf, zf

    (out_r, sf_r, zf_r), vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in names))
    grads_r = vjp((jnp.asarray(a["g"]), jnp.asarray(a["gsf"]), jnp.asarray(a["gzf"])))

    xs = [_t(a[n]).requires_grad_() for n in names]
    s0, z0 = (xs[3], xs[4]) if state else (None, None)
    out, sf, zf = causal_dot.LinearAttentionFn.apply(xs[0], xs[1], xs[2], s0, z0, 1e-6)
    grads = torch.autograd.grad((out, sf, zf), xs, (_t(a["g"]), _t(a["gsf"]), _t(a["gzf"])))
    assert plain_kernels == {"fwd": 1, "dq": 1, "rev": 1}
    for name, x, ref in zip(["out", "sf", "zf"], (out, sf, zf), (out_r, sf_r, zf_r)):
        _close(x, ref, name)
    for name, x, ref in zip(names, grads, grads_r):
        _close(x, ref, "d" + name)


def test_linear_attention_kernel_backend_runs_the_function(plain_kernels):
    """backend="cuda" with grad wanted goes through LinearAttentionFn (one
    forward, one dq and one reverse launch) and its grads equal autograd
    through the plain version (backend="torch"), initial state included."""
    a = _draw(5, 6, 50, 8, 8)
    q, k, v = (_t(a[n]).reshape(2, 3, 50, 8) for n in ("q", "k", "v"))
    s0, z0 = _t(a["s0"]).reshape(2, 3, 8, 8), _t(a["z0"]).reshape(2, 3, 8)
    grads = {}
    for backend in ("cuda", "torch"):
        xs = [x.clone().requires_grad_() for x in (q, k, v, s0, z0)]
        out, (sf, zf) = la.linear_attention(
            *xs[:3], backend=backend, initial_state=(xs[3], xs[4]), return_state=True
        )
        loss = (out * out).sum() + sf.sum() * 0.01 + (zf * zf).sum() * 0.01
        grads[backend] = torch.autograd.grad(loss, xs)
    assert plain_kernels == {"fwd": 1, "dq": 1, "rev": 1}
    for name, got, ref in zip(("q", "k", "v", "s0", "z0"), grads["cuda"], grads["torch"]):
        _close(got, ref.numpy(), "d" + name)
    with torch.no_grad():  # no grad wanted: the forward kernel alone
        la.linear_attention(q, k, v, backend="cuda")
    assert plain_kernels == {"fwd": 2, "dq": 1, "rev": 1}


def test_kernel_wrappers_raise_on_an_input_that_requires_grad():
    """The forward kernel's outputs carry no grad_fn, so its wrapper refuses
    an input that requires grad while grad is enabled -- before it looks at
    the device, so the raise shows here on the CPU."""
    q = torch.rand(2, 5, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="carries no gradient"):
        causal_dot.causal_dot_norm_cuda(q, q, q)
    with torch.no_grad(), pytest.raises(RuntimeError, match="CUDA tensors"):
        causal_dot.causal_dot_norm_cuda(q, q, q)
    g = torch.rand(2, 5, 4)
    gden = torch.rand(2, 5)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        causal_dot.causal_dot_dq_den_cuda(g, g, g, gden)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        causal_dot.causal_dot_rev_den_cuda(g, g, g, g, gden)
    with pytest.raises(ValueError, match="gden"):
        causal_dot.causal_dot_dq_den_plain(g, g, g, gden[:, :3])
    with pytest.raises(ValueError, match="gsf"):
        causal_dot.causal_dot_rev_den_plain(g, g, g, g, gden, torch.zeros(2, 4, 4), None)
