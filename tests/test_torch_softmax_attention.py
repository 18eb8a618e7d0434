"""The port's rotary, softmax attention and flash attention held against the
JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX functions
and their counterparts in the port. The JAX flash kernel runs in interpret
mode, as the JAX package's own tests run it; the port's flash wrappers on
CPU tensors are their plain versions, and ``FlashAttentionFn`` runs with the
plain versions standing in for its three kernels (this machine has no
card). Tolerances, all fp32: 2e-5 for outputs, lse and gradients, the JAX
package's own limit for flash against XLA (``tests/test_softmax_attention.py``):
the same exact products summed in another order, through one exp and one
division; 1e-5 for rotary (one fp32 rotation, cos/sin of the same angles).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops import rotary as jax_rotary
from orion_tpu.ops.pallas.flash_attention import flash_attention_lse as jax_flash_lse
from orion_tpu_torch.ops import rotary, softmax_attention as sa
from orion_tpu_torch.ops.kernels import flash_attention as fa

# the module, not the function that orion_tpu.ops exports under its name
jax_sa = importlib.import_module("orion_tpu.ops.softmax_attention")
torch.set_num_threads(2)

_TOL = dict(atol=2e-5, rtol=2e-5)
_CASES = [(True, None), (False, None), (True, 7)]


def _inputs(seed, *shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("t,d", [(12, 16), (1, 8), (40, 32)])
def test_rotary_matches_jax(t, d):
    (x,) = _inputs(t, 2, 3, t, d, n=1)
    pos = np.array([5, 63], dtype=np.int64)

    @jax.jit
    def jax_side(x_):
        table = jax_rotary.rotary_freqs(d, 64)
        return (table, jax_rotary.apply_rotary(x_, table[:t]),
                # decode time: one position per sequence, and a scalar one
                jax_rotary.apply_rotary_at(x_[:, :, 0], table, jnp.asarray(pos)[:, None]),
                jax_rotary.apply_rotary_at(x_[:, :, 0], table, 9))

    ref_table, ref, ref_at, ref_s = jax_side(jnp.asarray(x))
    table = rotary.rotary_freqs(d, 64)
    np.testing.assert_allclose(_np(table), _np(ref_table), rtol=1e-6, atol=0)
    got = rotary.apply_rotary(torch.from_numpy(x), table[:t])
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)
    got_at = rotary.apply_rotary_at(torch.from_numpy(x[:, :, 0]), table, torch.from_numpy(pos)[:, None])
    np.testing.assert_allclose(_np(got_at), _np(ref_at), rtol=1e-5, atol=1e-5)
    got_s = rotary.apply_rotary_at(torch.from_numpy(x[:, :, 0]), table, 9)
    np.testing.assert_allclose(_np(got_s), _np(ref_s), rtol=1e-5, atol=1e-5)
    bf = rotary.apply_rotary(torch.from_numpy(x).bfloat16(), table[:t])
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("causal,window", _CASES)
@pytest.mark.parametrize("t", [32, 50])
def test_softmax_attention_matches_jax(causal, window, t):
    q, k, v = _inputs(t, 2, 3, t, 16)
    ref = jax.jit(lambda *a: jax_sa.softmax_attention_xla(*a, causal=causal, window=window))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for backend in ("auto", "torch"):
        got = sa.softmax_attention(tq, tk, tv, causal=causal, window=window, backend=backend)
        np.testing.assert_allclose(_np(got), _np(ref), **_TOL)
    # a key-padding mask takes the plain form on any backend, as in JAX
    mask = np.arange(t)[None, None, None, :] < np.array([t, t - 5])[:, None, None, None]
    ref_m = jax.jit(lambda *a: jax_sa.softmax_attention(
        *a, causal=causal, window=window, mask=jnp.asarray(mask), backend="xla",
    ))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got_m = sa.softmax_attention(tq, tk, tv, causal=causal, window=window,
                                 mask=torch.from_numpy(mask), backend="cuda")
    np.testing.assert_allclose(_np(got_m), _np(ref_m), **_TOL)


def test_cached_attention_matches_jax():
    q, = _inputs(3, 2, 3, 16, n=1)
    kc, vc = _inputs(4, 2, 3, 24, 16, n=2)
    valid = np.arange(24)[None, None, :] <= np.array([10, 23])[:, None, None]
    ref = jax_sa.cached_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(valid))
    got = sa.cached_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                              torch.from_numpy(valid))
    np.testing.assert_allclose(_np(got), _np(ref), **_TOL)


@pytest.mark.parametrize("causal,window", _CASES)
@pytest.mark.parametrize("t", [32, 50])
def test_flash_plain_matches_jax_interpret(causal, window, t):
    q, k, v = _inputs(t + 1, 2, 3, t, 16)
    ref_out, ref_lse = jax.jit(lambda *a: jax_flash_lse(
        *a, causal=causal, window=window, block_q=16, block_k=16, interpret=True,
    ))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = fa.flash_attention_lse(tq, tk, tv, causal=causal, window=window)
    assert out.shape == (2, 3, t, 16) and lse.shape == (2, 3, t, 1)
    np.testing.assert_allclose(_np(out), _np(ref_out), **_TOL)
    np.testing.assert_allclose(_np(lse), _np(ref_lse), **_TOL)
    flat = [x.reshape(6, t, 16) for x in (tq, tk, tv)]
    out_p, lse_p = fa.flash_fwd_plain(*flat, causal=causal, window=window)
    np.testing.assert_allclose(_np(out_p).reshape(out.shape), _np(ref_out), **_TOL)
    np.testing.assert_allclose(_np(lse_p).reshape(lse.shape), _np(ref_lse), **_TOL)


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """The three flash wrappers, stood in for by their plain versions."""
    monkeypatch.setattr(fa, "flash_fwd_cuda", fa.flash_fwd_plain)
    monkeypatch.setattr(fa, "flash_dq_cuda", fa.flash_dq_plain)
    monkeypatch.setattr(fa, "flash_dkv_cuda", fa.flash_dkv_plain)


@pytest.mark.parametrize("causal,window", _CASES)
def test_flash_fn_grads_match_jax(causal, window, kernels_as_plain):
    """FlashAttentionFn's backward (delta with the lse's cotangent, then the
    dq and dk/dv passes) against jax.grad of the interpret-mode kernel, with
    cotangents on both outputs, at a ragged T."""
    t = 50
    q, k, v, w = _inputs(t + 2, 2, t, 16, n=4)
    (wl,) = _inputs(t + 3, 2, t, 1, n=1)

    def loss(q_, k_, v_):
        out, lse = jax_flash_lse(q_, k_, v_, causal=causal, window=window, block_q=16,
                                 block_k=16, interpret=True)
        return jnp.sum(out * w) + jnp.sum(lse * wl)

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.FlashAttentionFn.apply(tq, tk, tv, causal, window, None)
    ((out * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(wl)).sum()).backward()
    for got, r in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(_np(got), _np(r), **_TOL)
    # the plain version differentiated by autograd gives the same gradients
    pq, pk, pv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out_p, lse_p = fa.flash_attention_lse(pq, pk, pv, causal=causal, window=window)
    ((out_p * torch.from_numpy(w)).sum() + (lse_p * torch.from_numpy(wl)).sum()).backward()
    for got, r in zip((pq.grad, pk.grad, pv.grad), ref):
        np.testing.assert_allclose(_np(got), _np(r), **_TOL)


def test_flash_wrappers_refuse_what_they_do_not_take():
    q = torch.rand(2, 8, 16)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        fa.flash_fwd_cuda(q, q, q)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        fa.flash_attention(q, q, q, backend="cuda")
    with pytest.raises(RuntimeError, match="gradient"):
        fa.flash_fwd_cuda(q.requires_grad_(), q, q)
    q = q.detach()
    with pytest.raises(NotImplementedError, match="item 12"):
        fa.flash_attention_lse(q, q, q, shift=1)
    with pytest.raises(NotImplementedError, match="item 12"):
        fa.flash_attention_lse(q, q, q, q_offset=4)
    with pytest.raises(ValueError, match="window"):
        fa.flash_fwd_plain(q, q, q, window=0)
    lse = torch.zeros(2, 8, 1)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_dq_plain(q, q, q, q, lse, torch.zeros(2, 8))


def test_flash_plain_row_without_keys_gives_zero():
    """Tq > Tk with a window: the last query rows see no key; out is 0 and
    lse -1e30, as the TPU kernel's ``safe`` division gives."""
    q, = _inputs(9, 1, 10, 4, n=1)
    k, v = _inputs(10, 1, 2, 4, n=2)
    out, lse = fa.flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), window=3)
    assert torch.all(out[0, 5:] == 0) and torch.all(lse[0, 5:] == -1e30)
    assert torch.isfinite(out).all()
