"""The port's chunked-prefill pieces (``TransformerLM.prefill_extend_step``)
for linear, softmax and swa layers: the JAX package's in-scan cases
(``tests/test_prefill_inscan.py``: prompt length - piece size 5-8, 8-8,
19-8, 13-4, and 31-12 with a ragged last piece) against the port's own
bucketed ``prefill_last`` and against the JAX package's pieces.

Inside the port on the CPU the pieces are bitwise the monolithic prefill
where every product sums its rows alike: here at 19-8 and 31-12, and at
16-8. At 5-8, 8-8 and 13-4 they are not: the dense products of a piece of
P rows and of the whole T-row prompt go through the CPU's sgemm at other
row counts, which sums a row in another order (~1e-6 in the states), so
those cases hold within 1e-5 and the same greedy next token. The JAX
package's own pieces miss bitwise on the CPU at the same four cases
(ROADMAP.md C). Against JAX: fp32 logits and states within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.models.transformer import init_decode_state as jax_init_decode_state
from orion_tpu_torch.models.transformer import init_decode_state
from torch_serving_common import (CFG, JAX_CFG, TOL, assert_states_close, jax_model,
                                  jax_params, np_states, prompt, torch_model)

torch.set_num_threads(2)

CASES = [(5, 8), (8, 8), (19, 8), (13, 4), (31, 12)]
BITWISE = {(19, 8), (31, 12), (16, 8)}


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _padded(plen):
    bucket = -(-plen // 8) * 8
    tokens = prompt(plen, plen)
    return tokens, np.pad(tokens, ((0, 0), (0, bucket - plen)))


def _pieces(plen, pchunk, padded):
    off = 0
    while off < plen:
        cons = min(pchunk, plen - off)
        idx = np.clip(off + np.arange(pchunk), 0, padded.shape[1] - 1)
        yield off, cons, padded[:, idx]
        off += cons


def _port_pieces(model, plen, pchunk, padded):
    states = init_decode_state(CFG, 1, "cpu")
    with torch.inference_mode():
        for off, cons, piece in _pieces(plen, pchunk, padded):
            logits, states = model.prefill_extend_step(torch.from_numpy(piece), states, off, cons)
    return logits, states


def _readable(lt, x, plen):
    """A state's entries that decode reads after a prompt of ``plen``."""
    if lt == "softmax":
        return x[:, :, :plen]
    if lt == "swa":
        return x[:, :, np.arange(max(0, plen - CFG.window), plen) % CFG.window]
    return x


@pytest.mark.parametrize("plen,pchunk", CASES + [(16, 8)])
def test_pieces_equal_the_monolithic_prefill(model, plen, pchunk):
    tokens, padded = _padded(plen)
    logits, states = _port_pieces(model, plen, pchunk, padded)
    with torch.inference_mode():
        ref_logits, ref_states = model.prefill_last(torch.from_numpy(padded), plen)
    pairs = [(_readable(lt, g[k], plen), _readable(lt, r[k], plen))
             for lt, g, r in zip(CFG.layer_types, states, ref_states) for k in g]
    if (plen, pchunk) in BITWISE:
        assert torch.equal(logits, ref_logits)
        assert all(torch.equal(a, b) for a, b in pairs)
    else:
        torch.testing.assert_close(logits, ref_logits, rtol=1e-5, atol=1e-5)
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert int(logits.argmax()) == int(ref_logits.argmax())


@functools.lru_cache(maxsize=None)
def _jax_step():
    return jax.jit(functools.partial(jax_model().apply, method="prefill_extend_step"))


@pytest.mark.parametrize("plen,pchunk", CASES)
def test_pieces_match_jax_prefill_extend_step(model, plen, pchunk):
    tokens, padded = _padded(plen)
    params = jax_params()
    jstates = jax_init_decode_state(JAX_CFG, 1)
    for off, cons, piece in _pieces(plen, pchunk, padded):
        jlogits, jstates = _jax_step()(params, jnp.asarray(piece, jnp.int32), jstates,
                                      jnp.int32(off), jnp.int32(cons))
    logits, states = _port_pieces(model, plen, pchunk, padded)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert_states_close(states, np_states(jstates), lengths=[plen])


def test_a_piece_without_real_rows_changes_no_cache(model):
    """length 0 (a piece computed for a row that is not prefilling) writes
    no cache or ring entry, and its positions past the table are clipped."""
    states = init_decode_state(CFG, 1, "cpu")
    _, padded = _padded(13)
    with torch.inference_mode():
        _, states = model.prefill_extend_step(torch.from_numpy(padded[:, :8]), states, 0, 8)
        before = [{k: v.clone() for k, v in st.items()} for st in states]
        _, after = model.prefill_extend_step(torch.from_numpy(padded[:, :8]), states,
                                             CFG.max_seq_len - 2, 0)
    for lt, b, a in zip(CFG.layer_types, before, after):
        for k in b:
            assert torch.equal(a[k], b[k]), (lt, k)

