"""The port's chunked decode: ``generate_chunked`` emits ``generate``'s tokens
bitwise (greedy and sampled, chunk 1, 3, 16), a bucketed ``prefill_carry``
agrees with the exact one, ``reprefill_carry`` realigns ``sample_index`` and
``done``, the keyed sampler is row-independent, and the greedy walk matches
the JAX package's ``generate_chunked`` / ``prefill_carry``.

Sampled tokens were never comparable with JAX's threefry draws, so only the
port's own contracts pin them. Tolerances against JAX: fp32 logits and
states 1e-4 (``tests/test_torch_model.py``). A bucketed prefill is not
bitwise the exact one on the CPU (the dense products at another row count
sum in another order, ~1e-6): its states agree to 1e-5 and its greedy
tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.generate import generate_chunked as jax_generate_chunked
from orion_tpu.generate import prefill_carry as jax_prefill_carry
from orion_tpu_torch import generate as gen
from orion_tpu_torch.training.trainer import sr_noise_bits
from orion_tpu_torch.utils import rng as rngs
from torch_serving_common import (GREEDY, SAMPLED, assert_states_close, jax_model,
                                  jax_params, jax_sample, np_states, prompt, torch_model)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _prompts():
    return torch.from_numpy(np.concatenate([prompt(1, 11), prompt(2, 11)]))


@pytest.mark.parametrize("chunk", [1, 3, 16])
@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_generate_chunked_is_generate_bitwise(model, chunk, sample):
    p = _prompts()
    ref = gen.generate(model, p, 20, sample, 7)
    got = gen.generate_chunked(model, p, 20, chunk, sample, 7)
    assert torch.equal(got, ref)


def test_generate_takes_a_seed_or_a_generator(model):
    p = _prompts()
    a = gen.generate(model, p, 10, SAMPLED, 5)
    assert torch.equal(a, gen.generate(model, p, 10, SAMPLED, torch.Generator().manual_seed(5)))
    assert not torch.equal(a, gen.generate(model, p, 10, SAMPLED, 6))
    assert torch.equal(gen.generate(model, p, 10, SAMPLED), gen.generate(model, p, 10, SAMPLED, 0))


def test_one_row_request_keys_row_zero_of_a_batch():
    """A one-row request of seed s draws with row 0's key of any request of
    seed s; the rows' keys differ."""
    for seed in (0, 5, 2**40 + 3):
        keys = gen.request_keys(seed, 4)
        assert torch.equal(gen.request_keys(seed, 1)[0], keys[0])
        assert len({tuple(k.tolist()) for k in keys}) == 4
        assert int(keys.min()) >= 0 and int(keys.max()) < 2**32


def test_counter_bits_is_the_rounding_hash_row_by_row():
    """``counter_bits`` over a batch of keys is, row by row, the hash that
    ``sr_noise_bits`` draws (held bitwise against the JAX package's in
    ``tests/test_torch_model_options.py``)."""
    keys = rngs.fold_keys(torch.tensor([[1, 2], [2**32 - 1, 0], [7, 2**31]]),
                          torch.tensor([0, 9, 2**33 + 1]))
    bits = rngs.counter_bits(keys, 300)
    for row, key in zip(bits, keys):
        assert torch.equal(row, sr_noise_bits(tuple(key.tolist()), 300))


@pytest.mark.parametrize("sample", [SAMPLED, dataclasses.replace(SAMPLED, top_k=0, top_p=1.0),
                                    GREEDY], ids=["filtered", "plain", "greedy"])
def test_sample_rows_is_row_independent(sample):
    """Row b's draw depends on logits[b] and keys[b] alone: alone, in a
    batch of 8 and beside other rows it is the same token."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((8, 64), dtype=np.float32) * 2)
    keys = gen.request_keys(3, 8)
    for step in range(5):
        k = rngs.fold_keys(keys, step)
        batch = gen.sample_rows(logits, k, sample)
        other = gen.sample_rows(torch.flip(logits, [0]), torch.flip(k, [0]), sample)
        for b in range(8):
            solo = gen.sample_rows(logits[b:b + 1], k[b:b + 1], sample)
            assert int(solo) == int(batch[b]) == int(other[7 - b])


def test_sample_rows_keeps_the_filter_and_the_distribution():
    """Filtered tokens are never drawn; the draws of one row over many keys
    follow softmax(logits / T) (within 0.03 of each probability over 4000
    draws)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    keys = rngs.fold_keys(gen.request_keys(11, 1).expand(4000, 2), torch.arange(4000))
    cfg = gen.SampleConfig(temperature=1.0)
    draws = gen.sample_rows(logits.expand(4000, 6), keys, cfg)
    freq = torch.bincount(draws, minlength=6).float() / 4000
    assert float((freq - torch.softmax(logits[0], -1)).abs().max()) < 0.03
    top2 = gen.sample_rows(logits.expand(4000, 6), keys, gen.SampleConfig(temperature=1.0, top_k=2))
    assert set(top2.tolist()) == {0, 1}


def test_bucketed_prefill_carry_agrees_with_exact(model):
    p = torch.from_numpy(prompt(4, 13))
    keys = gen.request_keys(1, 1)
    for sample in (GREEDY, SAMPLED):
        exact = gen.prefill_carry(model, p, sample, keys)
        bucketed = gen.prefill_carry(model, p, sample, keys, buckets=(8, 16, 32))
        assert exact[2] == bucketed[2] == 13
        assert torch.equal(exact[0], bucketed[0]) and torch.equal(exact[3], bucketed[3])
        assert_states_close(bucketed[1], np_states(exact[1]), lengths=[13])
    assert gen.bucket_for(13, (8, 16, 32)) == 16 and gen.bucket_for(40, (8, 16, 32)) is None


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_reprefill_carry_realigns_the_walk(model, sample):
    """After n emitted tokens, ``reprefill_carry`` draws the next token at
    fold n, so its chunks continue the uninterrupted walk, and a row that
    emitted EOS is done."""
    p = _prompts()
    keys = gen.request_keys(9, 2)
    ref = gen.generate(model, p, 16, sample, 9)
    carry = gen.prefill_carry(model, p, sample, keys)
    carry, first = gen.decode_chunk(model, carry, keys, 0, 8, sample)
    fresh = gen.reprefill_carry(model, p, [first], sample, keys)
    assert fresh[2] == p.shape[1] + 8
    _, rest = gen.decode_chunk(model, fresh, keys, 8, 8, sample)
    assert torch.equal(torch.cat([first, rest], 1), ref)
    eos = gen.SampleConfig(temperature=0.0, eos_token=int(first[0, 2]))
    again = gen.reprefill_carry(model, p, [first], eos, keys)
    assert bool(again[3][0]) and bool(again[3][1]) == (eos.eos_token in first[1].tolist())
    with pytest.raises(ValueError, match="chunk"):
        gen.generate_chunked(model, p, 4, chunk=0)


def test_generate_chunked_and_prefill_carry_match_jax(model):
    jm, params = jax_model(), jax_params()
    p = _prompts()
    ref = jax_generate_chunked(jm, params, jnp.asarray(p.numpy(), jnp.int32), 12, chunk=5,
                               sample=jax_sample(GREEDY), rng=jax.random.PRNGKey(0))
    got = gen.generate_chunked(model, p, 12, 5, GREEDY)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    jtok, jstates, jt, jdone = jax_prefill_carry(jm, params, jnp.asarray(p.numpy(), jnp.int32),
                                                 jax_sample(GREEDY), jax.random.PRNGKey(0),
                                                 buckets=(16,))
    tok, states, t, done = gen.prefill_carry(model, p, GREEDY, gen.request_keys(0, 2),
                                             buckets=(16,))
    assert t == int(jt) == 11
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert_states_close(states, np_states(jstates), lengths=[11, 11])
