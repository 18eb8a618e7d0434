"""``shift`` and ``q_offset`` of flash attention (rows 6-8) held against the
JAX package's kernel, on the CPU.

The sequence-parallel rings call ``flash_attention_lse`` with the mask moved:
the striped ring's blocks at ``shift`` 0 or 1 (the strict triangle), the
halo's blocks at ``q_offset = m T_loc`` under the window
(``orion_tpu/parallel/ring.py``). Here the JAX kernel in interpret mode and
the port's plain version (its CPU path, and the function the CUDA kernels
are held against on the card) take the same numpy-drawn inputs at every
(shift, q_offset, window) combination those callers make, and a ragged one.
``out`` is compared on the rows that see at least one key (the JAX kernel
leaves the mean of the masked tile's v in a row that sees none; the port
writes 0), ``lse`` on those rows, and on the empty rows both lse are held at
or below the ring merge's guard (-5e29). Gradients for cotangents on every
row of out and lse, through ``jax.vjp`` and autograd. Tolerance 2e-5, the
JAX package's own limit for its flash kernel against XLA (as
``tests/test_torch_softmax_attention.py``). ``FlashAttentionFn`` takes the
two offsets through to its kernels: with the plain versions standing in for
them it matches too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.pallas.flash_attention import flash_attention_lse as jax_flash_lse
from orion_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(2)
_TOL = dict(atol=2e-5, rtol=2e-5)
GUARD = -5e29  # parallel/ring.py's _lse_merge drops a block at or below it

# (label, Tq, Tk, window, shift, q_offset): the striped ring's two block
# kinds, the halo at h = 1 (W - 1 <= T_loc) and h = 2 (its blocks at T_loc
# and 2 T_loc), a block whose every row is past the window, and ragged ones
CASES = [
    ("striped diagonal", 16, 16, None, 0, 0),
    ("striped strict", 16, 16, None, 1, 0),
    ("halo local", 16, 16, 6, 0, 0),
    ("halo h1 m1", 16, 16, 6, 0, 16),
    ("halo h2 m1", 8, 8, 12, 0, 8),
    ("halo h2 m2", 8, 8, 12, 0, 16),
    ("halo all rows empty", 8, 8, 4, 0, 16),
    ("ragged strict", 13, 13, None, 1, 0),
    ("ragged halo", 13, 13, 9, 0, 13),
]


def _inputs(seed, tq, tk, d=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 2, tq, d), dtype=np.float32)
    k, v = (rng.standard_normal((1, 2, tk, d), dtype=np.float32) for _ in range(2))
    w = rng.standard_normal((1, 2, tq, d), dtype=np.float32)
    wl = rng.standard_normal((1, 2, tq, 1), dtype=np.float32)
    return q, k, v, w, wl


def _jax_side(q, k, v, w, wl, **opts):
    fn = lambda a, b, c: jax_flash_lse(a, b, c, causal=True, interpret=True, **opts)  # noqa: E731
    (out, lse), vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp((jnp.asarray(w), jnp.asarray(wl)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


def _sees(tq, tk, window, shift, q_offset):
    """[Tq] bool: the rows that see at least one key."""
    return fa._mask(tq, tk, True, window, "cpu", shift, q_offset).any(dim=-1).numpy()


@pytest.mark.parametrize("label,tq,tk,window,shift,q_offset", CASES, ids=[c[0] for c in CASES])
def test_plain_version_matches_the_jax_kernel(label, tq, tk, window, shift, q_offset):
    q, k, v, w, wl = _inputs(tq * 31 + q_offset, tq, tk)
    opts = dict(window=window, shift=shift, q_offset=q_offset)
    r_out, r_lse, r_grads = _jax_side(q, k, v, w, wl, **opts)
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_lse(tq_, tk_, tv_, causal=True, **opts)
    ((out * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(wl)).sum()).backward()
    seen = _sees(tq, tk, window, shift, q_offset)
    o, ls = out.detach().numpy(), lse.detach().numpy()
    np.testing.assert_allclose(o[:, :, seen], r_out[:, :, seen], **_TOL)
    np.testing.assert_allclose(ls[:, :, seen], r_lse[:, :, seen], **_TOL)
    # empty rows: out 0 here, lse at or below the guard on both sides
    assert (o[:, :, ~seen] == 0).all()
    assert (ls[:, :, ~seen] <= GUARD).all() and (r_lse[:, :, ~seen] <= GUARD).all()
    for got, ref, name in zip((tq_.grad, tk_.grad, tv_.grad), r_grads, "qkv"):
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), ref, **_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("label,tq,tk,window,shift,q_offset",
                         [c for c in CASES if c[4] or c[5]], ids=[c[0] for c in CASES if c[4] or c[5]])
def test_flash_fn_takes_the_offsets_to_its_kernels(label, tq, tk, window, shift, q_offset,
                                                   monkeypatch):
    """``FlashAttentionFn`` with the plain versions standing in for its three
    kernels (this machine has no card) against autograd of the plain form:
    the offsets reach the forward and both backward passes."""
    monkeypatch.setattr(fa, "flash_fwd_cuda", fa.flash_fwd_plain)
    monkeypatch.setattr(fa, "flash_dq_cuda", fa.flash_dq_plain)
    monkeypatch.setattr(fa, "flash_dkv_cuda", fa.flash_dkv_plain)
    q, k, v, w, wl = _inputs(tq * 7 + shift, tq, tk)
    flat = [torch.from_numpy(x[0]) for x in (q, k, v)]
    a = [x.clone().requires_grad_() for x in flat]
    out, lse = fa.FlashAttentionFn.apply(*a, True, window, None, shift, q_offset)
    ((out * torch.from_numpy(w[0])).sum() + (lse * torch.from_numpy(wl[0])).sum()).backward()
    b = [x.clone().requires_grad_() for x in flat]
    r_out, r_lse = fa.flash_fwd_plain(*b, causal=True, window=window, shift=shift,
                                      q_offset=q_offset)
    ((r_out * torch.from_numpy(w[0])).sum() + (r_lse * torch.from_numpy(wl[0])).sum()).backward()
    torch.testing.assert_close(out, r_out, **_TOL)
    torch.testing.assert_close(lse, r_lse, **_TOL)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, **_TOL)


def test_an_empty_row_keeps_every_gradient_finite():
    """Rows past the window of a halo block see no key: lse -1e30, out 0,
    and dq, dk, dv finite (and 0 on those rows' q) even for a nonzero lse
    cotangent there."""
    q, k, v, w, wl = _inputs(5, 8, 8)
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_lse(tq_, tk_, tv_, causal=True, window=4, q_offset=16)
    assert (lse.detach() == -1e30).all() and (out.detach() == 0).all()
    ((out * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(wl)).sum()).backward()
    for g in (tq_.grad, tk_.grad, tv_.grad):
        assert torch.isfinite(g).all() and (g == 0).all()
