"""The port's hybrid model (sliding-window and full softmax layers beside a
linear one) held against the JAX package's, on the CPU.

A tiny hybrid: ``TINY``'s widths (d_model 128, 4 heads of 32, fp32) with 4
layers of types swa, swa, softmax, linear and a window of 16, so that a
40-token prompt is longer than the window and the ring cache wraps. Both
models carry the same weights, a flax tree drawn with numpy from a seed and
loaded into the port by ``convert.py``. The JAX side runs its Pallas
kernels in interpret mode (``backend="pallas_interpret"``) for the prefill
and decode states, and its XLA forms (quicker to compile) for the full
forward, the bucketed prefill and ``generate``; the port's side
runs the kernels' plain versions (CPU tensors). Training is held in
``tests/test_torch_hybrid_train.py``.

Tolerances (fp32): logits and states 1e-4, as ``tests/test_torch_model.py``.
Within the port, a
bucketed prefill equals the unpadded one to 1e-5 where decode reads it, and
decode steps agree with a longer prefill to 1e-4 (one query over the cache
against the materialized scores: the same products summed in another order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orion_tpu.generate import SampleConfig as JaxSampleConfig
from orion_tpu.generate import generate as jax_generate
from orion_tpu.models.configs import TINY as JAX_TINY
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu_torch import generate as gen
from orion_tpu_torch.convert import expected_params, load_jax_params
from orion_tpu_torch.models.configs import TINY
from orion_tpu_torch.models.transformer import (TransformerLM, init_decode_state,
                                                snapshot_decode_state)

torch.set_num_threads(2)

_HYBRID = dict(n_layers=4, layer_types=("swa", "swa", "softmax", "linear"), window=16)
CFG = dataclasses.replace(TINY, **_HYBRID)
JAX_CFG = dataclasses.replace(JAX_TINY, backend="pallas_interpret", **_HYBRID)
T = 40
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _tree(seed):
    """A flax param tree for the hybrid drawn with numpy at the flax init
    scales, norm scales around 1 so that they matter."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, (_, shape, transpose) in expected_params(CFG).items():
        shape = shape[::-1] if transpose else shape  # flax kernels are [in, out]
        if path.endswith("scale"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            arr = rng.standard_normal(shape) / np.sqrt(shape[0] if transpose else shape[1])
        node = tree
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": tree}


def _model(backend="auto"):
    return load_jax_params(
        TransformerLM(dataclasses.replace(CFG, backend=backend), device="cpu"), _tree(0))


def _tokens(seed, b=2, t=T):
    return np.random.default_rng(seed).integers(0, 256, (b, t), dtype=np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_states(got, ref):
    assert len(got) == len(ref)
    for lt, g, r in zip(CFG.layer_types, got, ref):
        assert set(g) == set(r) == ({"s", "z"} if lt == "linear" else {"k", "v"})
        for key in g:
            assert tuple(g[key].shape) == tuple(r[key].shape), (lt, key)
            scale = max(1.0, float(np.abs(_np(r[key])).max()))
            np.testing.assert_allclose(_np(g[key]), _np(r[key]), rtol=1e-4, atol=1e-4 * scale)


def test_prefill_and_decode_match_jax():
    jm, params = JaxLM(JAX_CFG), _tree(0)
    tokens = _tokens(1)
    nxt = np.array([3, 200], dtype=np.int32)
    ref_logits, ref_states = jax.jit(functools.partial(jm.apply, method="prefill"))(
        params, jnp.asarray(tokens))
    decode = jax.jit(functools.partial(jm.apply, method="decode_step"))
    ref_dec, ref_states2 = decode(params, jnp.asarray(nxt), ref_states, jnp.int32(T))
    # per-sequence positions: each row at its own step
    pos = np.array([T, T - 3], dtype=np.int32)
    ref_dec_b, _ = decode(params, jnp.asarray(nxt), ref_states, jnp.asarray(pos))
    model = _model()
    with torch.no_grad():
        logits, states = model.prefill(torch.from_numpy(tokens).long())
        # decode writes the caches in place: each step gets its own copy
        dec, states2 = model.decode_step(torch.from_numpy(nxt).long(),
                                         snapshot_decode_state(states), T)
        dec_b, _ = model.decode_step(torch.from_numpy(nxt).long(), snapshot_decode_state(states),
                                     torch.from_numpy(pos).long())
    assert logits.dtype == torch.float32 and logits.shape == tuple(ref_logits.shape)
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **TOL)
    _close_states(states, ref_states)
    np.testing.assert_allclose(_np(dec), _np(ref_dec), **TOL)
    _close_states(states2, ref_states2)
    np.testing.assert_allclose(_np(dec_b), _np(ref_dec_b), **TOL)


def test_forward_and_bucketed_prefill_match_jax():
    jm, params = JaxLM(dataclasses.replace(JAX_CFG, backend="xla")), _tree(0)
    tokens, length = _tokens(2), 29  # rows past 29 are padding
    ref = jax.jit(functools.partial(jm.apply, method="__call__"))(params, jnp.asarray(tokens))
    ref_last, ref_states = jax.jit(functools.partial(jm.apply, method="prefill_last"))(
        params, jnp.asarray(tokens), jnp.int32(length))
    model = _model()
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long())
        last, states = model.prefill_last(torch.from_numpy(tokens).long(), length=length)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)
    np.testing.assert_allclose(_np(last), _np(ref_last), **TOL)
    _close_states(states, ref_states)


def test_greedy_tokens_equal_jax_generate():
    params = _tree(0)
    prompt = _tokens(3, t=24)
    ref = jax_generate(
        JaxLM(dataclasses.replace(JAX_CFG, backend="xla")), params, jnp.asarray(prompt), 16,
        JaxSampleConfig(temperature=0.0), jax.random.PRNGKey(0),
    )
    out = gen.generate(_model(), torch.from_numpy(prompt), 16, gen.SampleConfig(temperature=0.0))
    assert out.shape == (2, 16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_bucketed_prefill_equals_unpadded():
    """In every slot decode reads: all of a swa ring and a linear layer's
    (S, z); a softmax cache below ``length`` (decode never reads the padded
    slots above it before overwriting them). To 1e-5, not bitwise as for a
    linear-only model: the padded keys add exact zeros to the softmax sums,
    but the products run over another key length, and the CPU's matrix
    product may then sum in another order."""
    model = _model()
    tokens = torch.from_numpy(_tokens(4, t=29)).long()
    for length in (29, 11):
        padded = torch.cat([tokens[:, :length], torch.full((2, 40 - length), 7)], dim=1)
        with torch.no_grad():
            logits, states = model.prefill_last(tokens[:, :length])
            plog, pstates = model.prefill_last(padded, length=torch.tensor(length))
        torch.testing.assert_close(plog, logits, rtol=1e-5, atol=1e-5)
        for lt, a, b in zip(CFG.layer_types, pstates, states):
            for key in a:
                got, ref = a[key], b[key]
                if lt == "softmax":
                    got, ref = got[:, :, :length], ref[:, :, :length]
                elif lt == "swa" and length < CFG.window:
                    got, ref = got[:, :, :length], ref[:, :, :length]  # slots >= length unread
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_prefill_then_decode_equals_longer_prefill():
    """prefill(10) and 20 decode steps, past the 16-slot ring's wrap, give
    prefill(30)'s logits at every step."""
    model = _model()
    tokens = torch.from_numpy(_tokens(5, t=30)).long()
    with torch.no_grad():
        full, _ = model.prefill(tokens)
        logits, states = model.prefill_last(tokens[:, :10])
        steps = [logits]
        for i in range(10, 29):
            logits, states = model.decode_step(tokens[:, i], states, i)
            steps.append(logits)
    torch.testing.assert_close(torch.stack(steps, 1), full[:, 9:29], **TOL)


def test_decode_from_zero_state_equals_prefill_of_one_token():
    model = _model()
    tok = torch.from_numpy(_tokens(6, t=1)[:, 0]).long()
    with torch.no_grad():
        ref, ref_states = model.prefill_last(tok[:, None])
        got, states = model.decode_step(tok, init_decode_state(CFG, 2, device="cpu"), 0)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    for lt, a, b in zip(CFG.layer_types, states, ref_states):
        assert a["k" if lt != "linear" else "s"].dtype == b["k" if lt != "linear" else "s"].dtype
        if lt == "swa":
            torch.testing.assert_close(a["k"][:, :, 0], b["k"][:, :, 0], rtol=1e-5, atol=1e-5)
