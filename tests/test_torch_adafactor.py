"""The port's Adafactor (``ops/kernels/adafactor.py``) held against optax's
``adafactor`` -- the JAX package's ``optimizer="adafactor"`` -- and the JAX
package's fused Adafactor in interpret mode, on the CPU.

Params and gradients are drawn with numpy in the JAX package's orientation
([in, out]); the port holds the dense-like leaves transposed ([out, in],
``TRANSPOSED``), as it stores every dense weight, and factors them over
optax's axes. The port runs both of its forms: the plain formulas
(``use_kernel=False``) and the three-pass kernel form, whose passes are
their plain versions on CPU tensors; ``_MIN_KERNEL_ELEMS`` is lowered on both
sides so that the small leaves take the kernel forms. Tolerances: rtol 2e-5
and atol 1e-7 on params, atol 1e-9 on the statistics, over 3 steps, the JAX
package's own for its fused form against optax (the same fp32 formulas,
with sums taken in another order and rsqrt in place of ** -0.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import orion_tpu.ops.pallas.adafactor as FA
from orion_tpu_torch.ops.kernels import adafactor as af

torch.set_num_threads(2)

SHAPES = {  # the JAX orientation
    "wide": (128, 256),  # n > m
    "tall": (256, 128),  # m > n
    "square": (128, 128),
    "bias": (256,),  # not factored
    "small": (16, 64),  # both dims below 128: not factored
    "expert": (2, 128, 192),  # 3-D, a MoE expert stack
}
TRANSPOSED = {"wide": True, "square": True}  # the port holds these as [out, in]
SCALE = {"wide": 0.3, "tall": 0.1}
PTOL, STOL = dict(rtol=2e-5, atol=1e-7), dict(rtol=2e-5, atol=1e-9)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * SCALE.get(k, 1.0)).astype(np.float32)
            for k, s in SHAPES.items()}


def _port(tree):
    """The port's layout of a JAX-oriented tree (contiguous copies)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v.T if TRANSPOSED.get(k) else v))
            for k, v in tree.items()}


def _jax_view(t, k):
    a = t.numpy()
    return a.T if TRANSPOSED.get(k) and a.ndim == 2 else a


def _dims():
    return {k: af.factored_dims(s[::-1] if TRANSPOSED.get(k) else s, TRANSPOSED.get(k, False))
            for k, s in SHAPES.items()}


def _optax(lr):
    return optax.adafactor(lr, min_dim_size_to_factor=128, multiply_by_parameter_scale=False)


def test_state_shapes_match_optax_and_the_square_leaf_is_factored_as_optax():
    params = _port(_tree(0))
    ours = af.init(params, _dims())
    fac = _optax(1e-2).init(jax.tree.map(jnp.asarray, _tree(0)))[0]
    for k in SHAPES:
        assert tuple(ours.v_row[k].shape) == tuple(fac.v_row[k].shape), k
        assert tuple(ours.v_col[k].shape) == tuple(fac.v_col[k].shape), k
        assert tuple(ours.v[k].shape) == tuple(fac.v[k].shape), k
    # a square [out, in] leaf: optax's d0 is axis 1 of [in, out], the port's
    # axis 0 -- with the flag; without it the two vectors trade meanings
    assert af.factored_dims((128, 128), transposed=True) == (1, 0)
    assert af.factored_dims((128, 128)) == (0, 1)
    g = _tree(5)
    _, state = _optax(1e-2).update(jax.tree.map(jnp.asarray, g), _optax(1e-2).init(
        jax.tree.map(jnp.asarray, _tree(0))), jax.tree.map(jnp.asarray, _tree(0)))
    for transposed in (True, False):
        p, gt = _port({"square": _tree(0)["square"]}), _port({"square": g["square"]})
        dims = {"square": af.factored_dims((128, 128), transposed)}
        s = af.apply_updates(gt, p, af.init(p, dims), lr=1e-2, scale=1.0, finite=True, dims=dims,
                             use_kernel=False)
        same = np.allclose(s.v_row["square"].numpy(), np.asarray(state[0].v_row["square"]),
                           **STOL)
        assert same == transposed


def test_three_steps_match_optax_and_the_jax_interpret_kernels(monkeypatch):
    """3 steps, the second with a binding clip (scale 0.37): optax's chain as
    the JAX Trainer runs it (scaled grads, update, apply), the JAX fused
    kernels in interpret mode, and the port's plain and kernel forms."""
    monkeypatch.setattr(FA, "_MIN_KERNEL_ELEMS", 0)
    monkeypatch.setattr(af, "_MIN_KERNEL_ELEMS", 0)
    lr, dims = 3e-3, _dims()
    tx = _optax(lr)

    @jax.jit
    def optax_step(opt_state, params, grads, scale):
        updates, opt_state = tx.update(jax.tree.map(lambda g: g * scale, grads), opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    o_params = jax.tree.map(jnp.asarray, _tree(0))
    o_state = tx.init(o_params)
    f_params, f_state = o_params, FA.init(o_params)
    ports = {}
    for use_kernel in (False, True):
        p = _port(_tree(0))
        ports[use_kernel] = [p, af.init(p, dims)]
    for i in range(3):
        g = _tree(10 + i)
        scale = 0.37 if i == 1 else 1.0
        o_params, o_state = optax_step(o_state, o_params, jax.tree.map(jnp.asarray, g),
                                       jnp.float32(scale))
        f_params, f_state = FA.apply_updates(
            jax.tree.map(jnp.asarray, g), f_params, f_state, lr=lr, scale=jnp.float32(scale),
            finite=jnp.bool_(True), backend="interpret")
        for use_kernel, (p, state) in ports.items():
            ports[use_kernel][1] = af.apply_updates(
                _port(g), p, state, lr=lr, scale=scale, finite=True, dims=dims,
                use_kernel=use_kernel)
            for k in SHAPES:
                got = _jax_view(p[k], k)
                np.testing.assert_allclose(got, np.asarray(o_params[k]), **PTOL,
                                           err_msg=f"kernels={use_kernel} step {i} {k}")
                np.testing.assert_allclose(got, np.asarray(f_params[k]), **PTOL,
                                           err_msg=f"kernels={use_kernel} step {i} {k}")
    fac = o_state[0]
    for use_kernel, (_, state) in ports.items():
        assert state.count == int(f_state.count) == 3
        for k in SHAPES:
            for name in ("v_row", "v_col", "v"):
                ours = getattr(state, name)[k].numpy()
                np.testing.assert_allclose(ours, np.asarray(getattr(fac, name)[k]), **STOL,
                                           err_msg=f"{name} {k}")
                np.testing.assert_allclose(ours, np.asarray(getattr(f_state, name)[k]), **STOL,
                                           err_msg=f"{name} {k}")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_a_nonfinite_step_keeps_params_and_state_bitwise(use_kernel, monkeypatch):
    monkeypatch.setattr(af, "_MIN_KERNEL_ELEMS", 0)
    dims = _dims()
    p = _port(_tree(0))
    state = af.apply_updates(_port(_tree(1)), p, af.init(p, dims), lr=1e-2, scale=1.0,
                             finite=True, dims=dims, use_kernel=use_kernel)
    before = {k: v.clone() for k, v in p.items()}
    stats = {n: {k: v.clone() for k, v in getattr(state, n).items()} for n in ("v_row", "v_col", "v")}
    g = _port(_tree(42))
    g["tall"][0, 0] = float("nan")
    g["bias"][3] = float("inf")
    new = af.apply_updates(g, p, state, lr=1e-2, scale=0.0, finite=False, dims=dims,
                           use_kernel=use_kernel)
    for k in SHAPES:
        assert torch.equal(p[k], before[k]), k
        for n in ("v_row", "v_col", "v"):
            assert torch.equal(getattr(new, n)[k], stats[n][k]), (n, k)
    assert new.count == state.count == 1  # the good-step count: d_t and the lr stay put


def test_parity_with_optax_across_a_skipped_step(monkeypatch):
    """good -> non-finite (skipped) -> good: the port's kernel form against
    optax with the JAX Trainer's skip policy, the decay and the lr at the
    good-step count after the skip."""
    monkeypatch.setattr(af, "_MIN_KERNEL_ELEMS", 0)
    lr, dims = 1e-2, _dims()
    tx = _optax(lr)
    o_params = jax.tree.map(jnp.asarray, _tree(0))
    o_state = tx.init(o_params)
    p = _port(_tree(0))
    state = af.init(p, dims)
    for i, finite in enumerate((True, False, True)):
        g = _tree(20 + i)
        if not finite:
            g = {k: v * np.float32("nan") for k, v in g.items()}
        state = af.apply_updates(_port(g), p, state, lr=lr, scale=1.0 if finite else 0.0,
                                 finite=finite, dims=dims)
        if finite:
            updates, o_state = tx.update(jax.tree.map(jnp.asarray, g), o_state, o_params)
            o_params = optax.apply_updates(o_params, updates)
    for k in SHAPES:
        np.testing.assert_allclose(_jax_view(p[k], k), np.asarray(o_params[k]), **PTOL, err_msg=k)
    assert state.count == 2


def test_a_strided_gradient_takes_the_kernel_form(monkeypatch):
    """The kernels' gate looks at shape, dtype and size only, as the JAX
    package's: a gradient that is a transposed view takes the three passes
    (their plain versions here) and gives bitwise what its contiguous copy
    gives."""
    monkeypatch.setattr(af, "_MIN_KERNEL_ELEMS", 0)
    calls = []
    apply = af.adafactor_apply
    monkeypatch.setattr(af, "adafactor_apply", lambda *a, **k: calls.append(1) or apply(*a, **k))
    dims = {"w": af.factored_dims((128, 256))}
    g_jax = torch.from_numpy(_tree(7)["tall"])  # [256, 128]
    results = []
    for g in (g_jax.t(), g_jax.t().contiguous()):  # [128, 256], strided and contiguous
        assert af.kernel_ok(g)
        p = {"w": torch.from_numpy(_tree(0)["wide"])}
        state = af.apply_updates({"w": g}, p, af.init(p, dims), lr=1e-2, scale=0.5, finite=True,
                                 dims=dims)
        results.append((p["w"], state.v_row["w"], state.v_col["w"]))
    assert len(calls) == 2
    for a, b in zip(*results):
        assert torch.equal(a, b)
