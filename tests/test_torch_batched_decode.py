"""The port's slot-multiplexed decode (``decode_batched_chunk``) and its
unified prefill + decode chunk (``decode_batched_prefill_chunk``):

(b) a request's tokens in an S-slot program are bitwise the same whether
    the other slots are empty, busy, admitted late (by a solo prefill or by
    in-scan pieces) or finishing at EOS, S in {2, 4, 8}, greedy and
    sampled, through ``SlotEngine``;
(c) free rows and rows held mid-prefill keep their states bitwise through
    a chunk, the swa ring included, and their t, emit index and done flag;
(d) ``extract_decode_slot(insert_decode_slot(...))`` round-trips, and a row
    moved to another slot decodes on as if it had stayed;

plus the per-slot finite probe, and the greedy walk against the JAX
package's ``decode_batched_chunk`` / ``decode_batched_prefill_chunk``
(tokens equal, the emitting rows' states within 1e-4). A slot's tokens also
equal a one-row ``generate`` at its seed, bitwise: a decode step's products
run at one row count (``decode_rows``; ``tests/test_torch_slot_engine.py``
holds it op by op). The other tests drive the programs themselves through
``torch_serving_common.Slots``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.generate import decode_batched_chunk as jax_decode_batched_chunk
from orion_tpu.generate import decode_batched_prefill_chunk as jax_decode_batched_prefill_chunk
from orion_tpu.generate import prefill_carry as jax_prefill_carry
from orion_tpu.models.transformer import init_decode_state as jax_init_decode_state
from orion_tpu.models.transformer import insert_decode_slot as jax_insert_decode_slot
from orion_tpu_torch import generate as gen
from orion_tpu_torch.models.transformer import (decode_state_finite,
                                                decode_state_finite_per_slot,
                                                extract_decode_slot, init_decode_state,
                                                insert_decode_slot, snapshot_decode_state)
from orion_tpu_torch.serving import DecodeRequest, SlotEngine
from torch_serving_common import (CFG, GREEDY, JAX_CFG, SAMPLED, Slots, assert_states_close,
                                  jax_model, jax_params, jax_sample, np_states, prompt,
                                  states_equal, torch_model)

torch.set_num_threads(2)
X_LEN, X_SEED, NEW = 9, 500, 12


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _x():
    return torch.from_numpy(prompt(0, X_LEN))


_MODES = {"host": {}, "inscan": {"prefill_buckets": (8, 16, 32), "prefill_chunk": 8}}


def _engine(model, slots, mode):
    return SlotEngine(model, slots=slots, chunk=4, device="cpu", **_MODES[mode])


def _alone(model, slots, sample, mode="host"):
    eng = _engine(model, slots, mode)
    eng.admit(DecodeRequest(_x(), NEW, sample, seed=X_SEED), tag="x")
    done = {}
    while eng.busy:
        done.update(dict(eng.step()))
    return done["x"].tokens[0].tolist()


def _crowded(model, slots, sample, mode):
    """X in the last slot, every other slot busy from the start, one of them
    ending early at EOS, and a request admitted late into each slot that
    frees up, through ``SlotEngine`` admitting by host prefill or in-scan."""
    eng = _engine(model, slots, mode)
    for j in range(slots - 1):
        eng.admit(DecodeRequest(prompt(10 + j, 3 + 2 * j), 2 if j == 0 else 8, sample,
                                seed=100 + j), tag=f"b{j}")
    assert eng.admit(DecodeRequest(_x(), NEW, sample, seed=X_SEED), tag="x") == slots - 1
    late, done = 0, {}
    while eng.busy or late < 3:
        while late < 3 and eng.has_free_slot:
            eng.admit(DecodeRequest(prompt(40 + late, 5 + 4 * late), 6, sample, seed=200 + late),
                      tag=f"late{late}")
            late += 1
        done.update(dict(eng.step()))
    return {tag: r.tokens[0].tolist() for tag, r in done.items()}


@pytest.mark.parametrize("slots", [2, 4, 8])
@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_a_request_is_bitwise_the_same_in_any_company(model, slots, sample):
    alone = _alone(model, slots, sample)
    # b0 stops at its EOS: the first token it emits is made its EOS
    b0 = gen.generate(model, torch.from_numpy(prompt(10, 3)), 2, sample, 100)[0, 0]
    eos = dataclasses.replace(sample, eos_token=int(b0))
    for mode in ("host", "inscan"):
        got = _crowded(model, slots, eos, mode)
        assert got["x"] == _alone(model, slots, eos, mode), mode
        assert got["b0"][0] == int(b0) and got["b0"][1:] == [eos.pad_token]
    assert len(alone) == NEW
    solo = gen.generate(model, _x(), NEW, sample, X_SEED)[0].tolist()
    assert alone == solo


def test_frozen_and_free_rows_are_bitwise_untouched():
    """(c): slot 1 free (holding an earlier request's state), slot 2 staged
    with the longest prompt left (never the piece's slot), slot 3 staged
    and taking the pieces, slot 0 decoding: through two unified chunks and a
    pure decode chunk slots 1 and 2 keep every layer's state -- (S, z), the
    KV cache and the swa ring -- and their t, emit and done."""
    model = torch_model()
    host = Slots(model, 4, SAMPLED)
    host.admit(1, "old", torch.from_numpy(prompt(3, 7)), 3, 4)
    host.chunk(4)
    assert host.owner[1] is None  # finished: its row keeps the old state
    host.admit(0, "a", _x(), X_SEED, NEW)
    host.stage(2, "long", torch.from_numpy(prompt(5, 30)), 5, 4)
    host.stage(3, "short", torch.from_numpy(prompt(6, 11)), 6, 4)
    held = [extract_decode_slot(host.states, j) for j in (1, 2)]
    carry_held = [[x[j].clone() for x in (host.carry[2], host.carry[3], host.carry[4])]
                  for j in (1, 2)]
    for pchunk in (8, 8, 0):
        if pchunk:
            host.chunk(3, pchunk=pchunk)
        else:
            host.active[2] = False  # a pure decode chunk: slot 2 rides as a free row
            host.chunk(3)
        for j, want, cw in zip((1, 2), held, carry_held):
            assert states_equal(extract_decode_slot(host.states, j), want), (pchunk, j)
            assert all(torch.equal(x[j], w) for x, w in
                       zip((host.carry[2], host.carry[3], host.carry[4]), cw))
    assert int(host.carry[2][3]) >= 11 and len(host.got["short"]) > 0


def test_extract_insert_round_trip_and_a_moved_row_decodes_on(model):
    """(d), and a row suspended and resumed in its slot decodes on bitwise."""
    host = Slots(model, 4, SAMPLED)
    for j in range(3):
        host.admit(j, f"r{j}", torch.from_numpy(prompt(20 + j, 6 + j)), 300 + j, 12)
    host.chunk(4)
    row = extract_decode_slot(host.states, 1)
    other = init_decode_state(CFG, 4, "cpu")
    for st in other:
        for x in st.values():
            x.normal_(generator=torch.Generator().manual_seed(0))
    before = snapshot_decode_state(other)
    insert_decode_slot(other, row, 3)
    assert states_equal(extract_decode_slot(other, 3), row)
    for j in (0, 1, 2):
        assert states_equal(extract_decode_slot(other, j), extract_decode_slot(before, j))
    # suspend r1 mid-walk and resume it in the same slot of a batch whose
    # other rows hold anything: its tokens are those of the uninterrupted walk
    stay = Slots(model, 4, SAMPLED)
    for j in range(3):
        stay.admit(j, f"r{j}", torch.from_numpy(prompt(20 + j, 6 + j)), 300 + j, 12)
    while stay.busy:
        stay.chunk(4)
    gen_ = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        for st in host.states:
            for x in st.values():
                x.normal_(generator=gen_)
    insert_decode_slot(host.states, row, 1)
    while host.busy:
        host.chunk(4)
    assert host.got["r1"] == stay.got["r1"]


def test_per_slot_finite_probe(model):
    host = Slots(model, 4, GREEDY)
    for j in range(4):
        host.admit(j, f"r{j}", torch.from_numpy(prompt(30 + j, 5 + j)), j, 8)
    ref = Slots(model, 4, GREEDY)
    for j in range(4):
        ref.admit(j, f"r{j}", torch.from_numpy(prompt(30 + j, 5 + j)), j, 8)
    assert decode_state_finite_per_slot(host.states).all() and bool(decode_state_finite(host.states))
    with torch.inference_mode():
        for st in host.states:
            for x in st.values():
                x[2] = float("nan")
    assert decode_state_finite_per_slot(host.states).tolist() == [True, True, False, True]
    assert not bool(decode_state_finite(host.states))
    while host.busy:
        host.chunk(4)
        ref.chunk(4)
    for j in (0, 1, 3):
        assert host.got[f"r{j}"] == ref.got[f"r{j}"]
    assert decode_state_finite_per_slot(host.states).tolist() == [True, True, False, True]


def _jax_slots(params, jm, prompts, slots):
    """The JAX package's batched carry with ``prompts`` prefilled solo into
    the first slots (greedy, slot keys PRNGKey(i))."""
    states = jax_init_decode_state(JAX_CFG, slots)
    tok = np.zeros(slots, np.int32)
    t = np.zeros(slots, np.int32)
    for j, p in enumerate(prompts):
        c = jax_prefill_carry(jm, params, jnp.asarray(p, jnp.int32), jax_sample(GREEDY),
                              jax.random.PRNGKey(j))
        states = jax_insert_decode_slot(states, c[1], j)
        tok[j], t[j] = int(c[0][0]), int(c[2])
    rngs = jnp.stack([jax.random.PRNGKey(j) for j in range(slots)])
    return [jnp.asarray(tok), states, jnp.asarray(t), jnp.zeros(slots, jnp.int32),
            jnp.zeros(slots, bool)], rngs


def test_decode_batched_chunk_matches_jax(model):
    jm, params = jax_model(), jax_params()
    prompts = [prompt(50 + j, 4 + 3 * j) for j in range(3)]
    carry, rngs = _jax_slots(params, jm, prompts, 4)
    active = jnp.asarray([True, True, True, False])
    jcarry, jtoks = jax_decode_batched_chunk(jm, params, tuple(carry), rngs, active, 6,
                                             jax_sample(GREEDY))
    host = Slots(model, 4, GREEDY)
    for j, p in enumerate(prompts):
        host.admit(j, j, torch.from_numpy(p), j, 6)
    toks = host.chunk(6)
    np.testing.assert_array_equal(toks[:3].numpy(), np.asarray(jtoks)[:3])
    np.testing.assert_array_equal(host.carry[2][:3].numpy(), np.asarray(jcarry[2])[:3])
    ref = [{k: v[:3] for k, v in st.items()} for st in np_states(jcarry[1])]
    assert_states_close(host.states, ref, rows=slice(0, 3),
                        lengths=[int(x) for x in np.asarray(jcarry[2])[:3]])


def test_decode_batched_prefill_chunk_matches_jax(model):
    """Slot 0 decoding, slot 1 staged with a 13-token prompt in a 16-wide
    buffer and consumed in pieces of 8: three unified chunks of 4 steps."""
    jm, params = jax_model(), jax_params()
    p0, p1 = prompt(60, 6), prompt(61, 13)
    carry, rngs = _jax_slots(params, jm, [p0], 2)
    pbuf = np.zeros((2, 16), np.int32)
    pbuf[1, :13] = p1[0]
    plen = jnp.asarray([0, 13], jnp.int32)
    active = jnp.asarray([True, True])
    carry = tuple(carry)
    jtoks = []
    for _ in range(3):
        carry, toks = jax_decode_batched_prefill_chunk(
            jm, params, carry, rngs, active, jnp.asarray(pbuf), plen, jnp.zeros(2, jnp.int32),
            4, 8, jax_sample(GREEDY))
        jtoks.append(np.asarray(toks))
    host = Slots(model, 2, GREEDY, bucket=16)
    host.admit(0, 0, torch.from_numpy(p0), 0, 100)
    host.stage(1, 1, torch.from_numpy(p1), 1, 100)
    got = np.concatenate([host.chunk(4, pchunk=8).numpy() for _ in range(3)], axis=1)
    np.testing.assert_array_equal(got, np.concatenate(jtoks, axis=1))
    t = [int(x) for x in np.asarray(carry[2])]
    assert host.carry[2].tolist() == t and host.carry[3].tolist() == np.asarray(carry[3]).tolist()
    assert_states_close(host.states, np_states(carry[1]), lengths=t)
