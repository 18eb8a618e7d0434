"""The port's quantizers, int4 packing and quantized layers held against the
JAX package's ``orion_tpu/quant.py``, on the CPU.

Inputs are drawn with numpy and handed to both. Tolerances: the quantized
values and scales bitwise (both divide in fp32 and round half to even; the
test counts any disagreement, which could only be a one-step difference at
an exact .5 tie, and allows none); ``q4_matmul_torch`` against the
interpret-mode Pallas kernel to 1e-4, as ``tests/test_quant.py`` holds the
kernel against its own split form; the layers in fp32 to 1e-5 relative plus
1e-6 (the same exact products summed in another order), in bf16 to one bf16
step (2^-7 relative) plus 1e-2 absolute, since both round each of the two
half products to bf16 before adding them and may land on neighbouring values.
"""

import flax.linen  # noqa: F401  (the JAX layers below)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu import quant as jq
from orion_tpu_torch import quant as tq
from orion_tpu_torch.ops.kernels import q4_matmul as q4

torch.set_num_threads(2)


def _w(seed, shape, spread=True):
    """Weights whose channels differ in scale (per-tensor scaling would lose
    the small ones)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    if spread:
        w *= np.linspace(0.01, 3.0, shape[-1], dtype=np.float32)
    return w


def _mismatches(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    return int((got != want).sum())


@pytest.mark.parametrize("shape,axes", [((64, 32), (0,)), ((32, 48), (1,)), ((3, 40, 24), (1,)),
                                        ((7, 5), (0,))])
def test_quantize_int8_is_bitwise_jax(shape, axes):
    w = _w(sum(shape), shape)
    q, s = tq.quantize_int8(torch.from_numpy(w), axes)
    jqv, js = jq.quantize_int8(jnp.asarray(w), axes)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert _mismatches(q.numpy(), jqv) == 0  # one int8 step at a .5 tie would count here
    assert _mismatches(s.numpy(), js) == 0
    deq = q.float() * s.unsqueeze(axes[0])
    assert bool(((deq - torch.from_numpy(w)).abs() <= s.unsqueeze(axes[0]) / 2 + 1e-9).all())


@pytest.mark.parametrize("shape", [(64, 300), (2, 1), (128, 7), (10, 64)])
def test_quantize_int4_packed_is_bitwise_jax(shape):
    w = _w(shape[0] + 3, shape)
    p, s = tq.quantize_int4_packed(torch.from_numpy(w))
    jp, js = jq.quantize_int4_packed(jnp.asarray(w))
    assert p.shape == (shape[0] // 2, shape[1]) and p.dtype == torch.int8
    assert _mismatches(p.numpy(), jp) == 0
    assert _mismatches(s.numpy(), js) == 0


@pytest.mark.parametrize("d_in,out", [(2, 1), (2, 15), (30, 33)])
def test_unpack_round_trips_every_nibble_at_both_positions(d_in, out):
    """q in [-7, 7] with a +-7 in every column (so s = 1 and w = q exactly),
    -7, -1, 0, 7 at even (low nibble) and odd (high nibble) rows: packing and
    unpacking give q back, and the packed bytes are the JAX package's."""
    rng = np.random.default_rng(d_in * out)
    q = rng.integers(-7, 8, (d_in, out)).astype(np.int8)
    edge = np.array([-7, -1, 0, 7], np.int8)
    q[0, : min(4, out)] = edge[: min(4, out)]
    q[1, : min(4, out)] = edge[::-1][: min(4, out)]
    q[0, 0] = q[1, 0] = -7
    q[rng.integers(0, d_in, out), np.arange(out)] = 7  # every column's max |q| is 7
    w = torch.from_numpy(q.astype(np.float32))
    p, s = tq.quantize_int4_packed(w)
    assert bool((s == 1.0).all())
    np.testing.assert_array_equal(tq._unpack_nibbles(p, d_in).numpy(), q)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jq.quantize_int4_packed(jnp.asarray(w))[0]))
    np.testing.assert_array_equal(np.asarray(jq._unpack_nibbles(jnp.asarray(p.numpy()), d_in)), q)
    lo, hi = tq.unpack_nibbles(p)
    np.testing.assert_array_equal(lo.numpy(), q[0::2])
    np.testing.assert_array_equal(hi.numpy(), q[1::2])


@pytest.mark.parametrize("b,d,out", [(3, 64, 300), (1, 100, 200), (4, 256, 64), (64, 32, 130)])
def test_q4_matmul_torch_matches_the_interpret_mode_kernel(b, d, out):
    w = _w(d + out, (d, out), spread=False) * 0.2
    p, s = jq.quantize_int4_packed(jnp.asarray(w))
    x = np.random.default_rng(b).standard_normal((b, d)).astype(np.float32)
    want = np.asarray(jq.q4_matmul(jnp.asarray(x), p, s, block_out=128, interpret=True))
    pt, st = torch.from_numpy(np.array(p)), torch.from_numpy(np.array(s))
    got = q4.q4_matmul_torch(torch.from_numpy(x), pt, st)
    assert got.dtype == torch.float32 and got.shape == (b, out)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    split = tq.q4_split(torch.from_numpy(x), pt, st, torch.float32)
    np.testing.assert_allclose(split.numpy(), want, rtol=1e-4, atol=1e-4)


def _tol(dtype):
    return dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=2**-7, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_layers_match_flax(dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    d_in, d_out, vocab = 64, 48, 40
    w = _w(1, (d_in, d_out))
    x = np.random.default_rng(2).standard_normal((2, 5, d_in)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)

    q8, s8 = jq.quantize_int8(jnp.asarray(w), (0,))
    want = jq.Int8Dense(d_out, dtype=jdt).apply({"params": {"kernel_q": q8, "kernel_s": s8}}, xj)
    layer = tq.Int8Dense(d_in, d_out, tdt)
    layer.weight_q.copy_(torch.from_numpy(np.array(q8)).t())
    layer.weight_s.copy_(torch.from_numpy(np.array(s8)))
    got = layer(xt)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype))

    p4, s4 = jq.quantize_int4_packed(jnp.asarray(w))
    want = jq.Int4Dense(d_out, dtype=jdt).apply({"params": {"kernel_p4": p4, "kernel_s": s4}}, xj)
    layer = tq.Int4Dense(d_in, d_out, tdt)
    layer.weight_p4.copy_(torch.from_numpy(np.array(p4)))
    layer.weight_s.copy_(torch.from_numpy(np.array(s4)))
    got = layer(xt)
    assert got.dtype == tdt and got.shape == (2, 5, d_out)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype))

    table = _w(3, (vocab, d_in))
    qe, se = jq.quantize_int8(jnp.asarray(table), (1,))
    emb = jq.Int8Embed(vocab, d_in)
    ev = {"params": {"embedding_q": qe, "embedding_s": se}}
    ids = np.array([[0, 5, 39], [7, 7, 1]], np.int32)
    layer = tq.Int8Embed(vocab, d_in)
    layer.weight_q.copy_(torch.from_numpy(np.array(qe)))
    layer.weight_s.copy_(torch.from_numpy(np.array(se)))
    np.testing.assert_array_equal(layer(torch.from_numpy(ids).long()).numpy(),
                                  np.asarray(emb.apply(ev, jnp.asarray(ids))))
    want = emb.apply(ev, xj, jdt, method="attend")
    got = layer.attend(xt, tdt)
    assert got.dtype == torch.float32  # the head's logits stay fp32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_shapes_the_port_refuses():
    x, p, s = torch.zeros(2, 8), torch.zeros(4, 6, dtype=torch.int8), torch.ones(6)
    with pytest.raises(ValueError, match="even contraction"):
        q4.q4_matmul_torch(torch.zeros(2, 7), p, s)
    with pytest.raises(ValueError, match="packed kernel rows"):
        q4.q4_matmul_torch(torch.zeros(2, 10), p, s)
    with pytest.raises(ValueError, match="scale shape"):
        q4.q4_matmul_torch(x, p, torch.ones(5))
    with pytest.raises(ValueError, match="x \\[B, d\\]"):
        q4.q4_matmul_torch(x[0], p, s)
    with pytest.raises(ValueError, match="even input dim"):
        tq.quantize_int4_packed(torch.zeros(5, 3))
    with pytest.raises(ValueError, match="even input dim"):
        tq.Int4Dense(7, 3, torch.float32)
    with pytest.raises(ValueError, match="quant must be"):
        tq.check_mode("int2")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        q4.q4_matmul_cuda(x, p, s)  # the kernel takes CUDA tensors only
    with pytest.raises(ValueError, match="at most 64 rows"):
        q4.q4_matmul_cuda(torch.zeros(65, 8), p, s)
    layer = tq.Int4Dense(8, 6, torch.float32, backend="cuda")  # the kernel asked for, on the CPU
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        layer(x)
    assert layer(torch.zeros(65, 8)).shape == (65, 6)  # above the gate: the split form
