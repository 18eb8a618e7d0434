"""The port's linear attention held against the JAX package's.

The same inputs, made with numpy from a seed, go through the JAX fused
Pallas kernel (in interpret mode, as the JAX tests run it on the CPU) and
through ``orion_tpu_torch.ops.linear_attention`` -- on a CPU tensor, the CUDA
kernel's plain version. Tolerances: fp32 outputs and states agree to 1e-5
relative (summation order differs); bf16 outputs to one bf16 rounding step
(both sides divide in fp32 and round once, so a value near a rounding
boundary may land on either neighbour: 2^-7 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.linear_attention import recurrent_step as jax_recurrent_step
from orion_tpu.ops.pallas.causal_dot import linear_attention_pallas_fused
from orion_tpu.ops.feature_maps import make_feature_map as jax_feature_map
from orion_tpu_torch.ops import linear_attention as la
from orion_tpu_torch.ops.feature_maps import make_feature_map, register_feature_map
from orion_tpu_torch.ops.kernels import causal_dot

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _elu1(x):
    return np.where(x > 0, x + 1.0, np.exp(np.minimum(x, 0.0))).astype(np.float32)


def _inputs(seed, b=2, h=3, t=37, dk=16, dv=24, state=False):
    rng = np.random.default_rng(seed)
    q = _elu1(rng.standard_normal((b, h, t, dk), dtype=np.float32))
    k = _elu1(rng.standard_normal((b, h, t, dk), dtype=np.float32))
    v = rng.standard_normal((b, h, t, dv), dtype=np.float32)
    st = None
    if state:
        s0 = rng.standard_normal((b, h, dk, dv), dtype=np.float32)
        z0 = np.abs(rng.standard_normal((b, h, dk), dtype=np.float32)) * 4.0
        st = (s0, z0)
    return q, k, v, st


def _both(x, dtype):
    jdt, tdt = _DT[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize(
    "dtype,t,state,chunk",
    [
        ("float32", 37, False, None),
        ("float32", 37, True, 16),
        ("float32", 1, True, None),
        ("float32", 128, True, 32),
        ("bfloat16", 37, True, None),
        ("bfloat16", 1, False, 16),
        ("bfloat16", 100, True, 16),
    ],
)
def test_linear_attention_matches_pallas_fused(dtype, t, state, chunk):
    q, k, v, st = _inputs(t, t=t, state=state)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    jst = tst = None
    if st is not None:
        jst = tuple(jnp.asarray(a) for a in st)
        tst = tuple(torch.from_numpy(a) for a in st)
    ref_out, (ref_s, ref_z) = linear_attention_pallas_fused(
        jq, jk, jv, initial_state=jst, return_state=True, interpret=True
    )
    before = causal_dot.launches
    out, (s, z) = la.linear_attention(
        tq, tk, tv, initial_state=tst, return_state=True, chunk=chunk
    )
    assert causal_dot.launches == before  # CPU tensors: the plain version
    assert out.dtype == _DT[dtype][1] and out.shape == tuple(ref_out.shape)
    assert s.dtype == torch.float32 and z.dtype == torch.float32
    tol = dict(rtol=2**-7, atol=2**-7) if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(out), _f32(ref_out), **tol)
    scale = float(np.abs(_f32(ref_s)).max())
    np.testing.assert_allclose(_f32(s), _f32(ref_s), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(_f32(z), _f32(ref_z), rtol=1e-5, atol=1e-5)


def test_backend_torch_equals_auto_on_cpu_and_cuda_raises():
    q, k, v, st = _inputs(7, state=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tst = tuple(torch.from_numpy(a) for a in st)
    a = la.linear_attention(tq, tk, tv, initial_state=tst, return_state=True)
    b = la.linear_attention(tq, tk, tv, initial_state=tst, return_state=True, backend="torch")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1][0])
    with pytest.raises(RuntimeError, match="CUDA"):
        la.linear_attention(tq, tk, tv, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        la.linear_attention(tq, tk, tv, backend="pallas")


def test_chunked_matches_eager_and_zcum_fold():
    q, k, v, _ = _inputs(3, t=70)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = la.causal_dot_product_eager(tq, tk, tv)
    for chunk in (8, 16, 64):
        out = la.causal_dot_product_chunked(tq, tk, tv, chunk=chunk)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
    # strict left fold: a split at a chunk boundary, threading (S, z),
    # replays the same sums -- bitwise
    full = la.causal_dot_product_chunked(tq, tk, tv, chunk=16, return_zcum=True)
    a = la.causal_dot_product_chunked(
        tq[..., :32, :], tk[..., :32, :], tv[..., :32, :], chunk=16, return_zcum=True
    )
    b = la.causal_dot_product_chunked(
        tq[..., 32:, :], tk[..., 32:, :], tv[..., 32:, :], chunk=16,
        initial_state=a[2], initial_z=a[3], return_zcum=True,
    )
    assert torch.equal(torch.cat([a[0], b[0]], dim=-2), full[0])
    assert torch.equal(torch.cat([a[1], b[1]], dim=-2), full[1])
    assert torch.equal(b[2], full[2]) and torch.equal(b[3], full[3])


def test_recurrent_step_matches_jax():
    q, k, v, st = _inputs(11, t=1, state=True)
    ref_out, (ref_s, ref_z) = jax_recurrent_step(
        jnp.asarray(q[:, :, 0]), jnp.asarray(k[:, :, 0]), jnp.asarray(v[:, :, 0]),
        tuple(jnp.asarray(a) for a in st),
    )
    out, (s, z) = la.recurrent_step(
        torch.from_numpy(q[:, :, 0]), torch.from_numpy(k[:, :, 0]),
        torch.from_numpy(v[:, :, 0]), tuple(torch.from_numpy(a) for a in st),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), rtol=1e-6, atol=1e-6)


def test_prefill_then_recurrent_decode_equals_parallel_pass():
    """The core invariant: prefill to (S, z), then recurrent steps, gives
    the rows of one parallel pass over the whole sequence."""
    q, k, v, _ = _inputs(5, t=45)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    full = la.linear_attention(tq, tk, tv, chunk=16)
    t0 = 29
    pre, state = la.linear_attention(
        tq[..., :t0, :], tk[..., :t0, :], tv[..., :t0, :], chunk=16, return_state=True
    )
    rows = [pre]
    for t in range(t0, 45):
        o, state = la.recurrent_step(tq[..., t, :], tk[..., t, :], tv[..., t, :], state)
        rows.append(o[..., None, :])
    torch.testing.assert_close(torch.cat(rows, dim=-2), full, rtol=1e-5, atol=1e-5)
    s, z = la.kv_state(tk, tv)
    torch.testing.assert_close(state[0], s, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(state[1], z, rtol=1e-5, atol=1e-5)


def test_noncausal_matches_jax():
    from orion_tpu.ops.linear_attention import linear_attention_noncausal as jax_nc

    q, k, v, _ = _inputs(9, t=20)
    mask = np.arange(20)[None, None, :] < np.array([13, 20])[:, None, None]
    ref = jax_nc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask))
    out = la.linear_attention_noncausal(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=torch.from_numpy(mask),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["elu1", "relu", "sqrelu", "exp", "identity"])
def test_feature_maps_match_jax(name):
    x = np.random.default_rng(0).standard_normal((3, 40), dtype=np.float32)
    ref = np.asarray(jax_feature_map(name)(jnp.asarray(x)))
    np.testing.assert_allclose(
        make_feature_map(name)(torch.from_numpy(x)).numpy(), ref, rtol=1e-6, atol=1e-6
    )


def test_feature_map_registry():
    # favor needs its projection's generator; learnable lives in the model
    # (both ported: tests/test_torch_model_options.py)
    with pytest.raises(ValueError, match="generator"):
        make_feature_map("favor")
    with pytest.raises(ValueError, match="unknown"):
        make_feature_map("learnable")
    with pytest.raises(ValueError):
        register_feature_map("elu1", lambda x: x)
    register_feature_map("torch_test_softplus", torch.nn.functional.softplus)
    x = torch.linspace(-3, 3, 7)
    assert torch.equal(make_feature_map("torch_test_softplus")(x), torch.nn.functional.softplus(x))
