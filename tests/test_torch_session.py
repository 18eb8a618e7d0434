"""The port's ``DecodeSession``: chunked decode equal to ``generate``, the
degradation ladder driven by injected NaN (``resilience/inject.py``): (e)
the rewind rung reproduces the uninterrupted tokens bitwise, the re-prefill
rung too, ``LadderExhausted`` fails only the request; a deadline; the
boundary snapshot left intact by an attempt that poisons its state (the
decode advances the caches in place, so the session never hands the
snapshot itself to an attempt: the first runs on the live carry, each
later one on a fresh copy); the trimmed ``inject`` and ``flight`` copies
against the JAX package's."""

import numpy as np
import pytest
import torch

from orion_tpu.obs import flight as jax_flight
from orion_tpu.resilience import inject as jax_inject
from orion_tpu_torch import generate as gen
from orion_tpu_torch.models.transformer import snapshot_decode_state
from orion_tpu_torch.obs import flight
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.serving import DecodeRequest, DecodeSession, LadderExhausted
from torch_serving_common import GREEDY, SAMPLED, prompt, states_equal, torch_model

torch.set_num_threads(2)
NEW = 18


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _prompt():
    return np.concatenate([prompt(90, 10), prompt(91, 10)])


def _run(model, sample, plan=None, chunk=4, **kw):
    session = DecodeSession(model, chunk=chunk, **kw)
    request = DecodeRequest(_prompt(), NEW, sample, seed=21)
    if plan is None:
        return session.run(request)
    with inject.inject(plan):
        return session.run(request)


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_uninterrupted_session_is_generate(model, sample):
    ref = gen.generate(model, torch.from_numpy(_prompt()), NEW, sample, 21)
    res = _run(model, sample)
    assert res.status == "ok" and res.new_tokens == NEW and res.chunks == 5
    np.testing.assert_array_equal(res.tokens, ref.numpy())


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("times,rewinds,reprefills", [(1, 1, 0), (2, 1, 1)],
                         ids=["rewind", "reprefill"])
def test_ladder_rungs_reproduce_the_uninterrupted_tokens(model, sample, times, rewinds,
                                                         reprefills):
    """(e): a NaN injected after chunk 2's attempt; the rewind redoes the
    chunk from the snapshot, bitwise; with the retry poisoned too, the
    re-prefill rebuilds from the tokens (bitwise here as well)."""
    ref = _run(model, sample)
    flight.recorder().clear()
    res = _run(model, sample, inject.FaultPlan().poison_decode_state_at(2, times))
    assert res.status == "ok" and (res.rewinds, res.reprefills) == (rewinds, reprefills)
    assert res.degraded
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    rungs = [e["rung"] for e in flight.recorder().events("ladder")]
    assert rungs == ["rewind", "reprefill"][:times]


def test_ladder_exhausted_fails_the_request_only(model):
    flight.recorder().clear()
    ref = _run(model, GREEDY)
    res = _run(model, GREEDY, inject.FaultPlan().poison_decode_state_at(1, times=-1))
    assert res.status == "failed" and res.new_tokens == 4 and res.chunks == 1
    np.testing.assert_array_equal(res.tokens, ref.tokens[:, :4])
    assert [e["rung"] for e in flight.recorder().events("ladder")] == [
        "rewind", "reprefill", "exhausted"]
    assert _run(model, GREEDY).status == "ok"  # the session serves on
    with pytest.raises(LadderExhausted):
        session = DecodeSession(model, chunk=4)
        keys = gen.request_keys(0, 2)
        carry = gen.prefill_carry(model, _prompt(), GREEDY, keys)
        snap = (carry[0], snapshot_decode_state(carry[1]), *carry[2:])
        with inject.inject(inject.FaultPlan().poison_decode_state_at(0, times=-1)):
            session._chunk_with_ladder(torch.from_numpy(_prompt()), [], carry, snap, keys, 0, 4,
                                       GREEDY, 0)


def test_an_attempt_leaves_the_snapshot_intact(model):
    """The first attempt poisons its state in place; the snapshot taken at
    the boundary is bitwise what it was, owns its tensors, and the rewind
    from it gives the clean chunk."""
    session = DecodeSession(model, chunk=4)
    keys = gen.request_keys(21, 2)
    carry = gen.prefill_carry(model, _prompt(), SAMPLED, keys)
    carry, _ = gen.decode_chunk(model, carry, keys, 0, 4, SAMPLED)
    snap = (carry[0], snapshot_decode_state(carry[1]), *carry[2:])
    kept = snapshot_decode_state(snap[1])
    clean = gen.decode_chunk(model, (carry[0], snapshot_decode_state(carry[1]), *carry[2:]),
                             keys, 4, 4, SAMPLED)[1]
    live = {x.data_ptr() for st in carry[1] for x in st.values()}
    assert not live & {x.data_ptr() for st in snap[1] for x in st.values()}
    with inject.inject(inject.FaultPlan().poison_decode_state_at(1, times=1)):
        _, toks, rewinds, reprefills = session._chunk_with_ladder(
            torch.from_numpy(_prompt()), [], carry, snap, keys, 4, 4, SAMPLED, 1)
    assert (rewinds, reprefills) == (1, 0)
    assert torch.equal(toks, clean)
    assert states_equal(snap[1], kept)
    assert not all(torch.isfinite(x).all() for st in carry[1] for x in st.values()
                   if x.is_floating_point())  # the live carry took the poison


def test_deadline_at_a_chunk_boundary(model):
    """An injectable clock: 2 chunks fit in the deadline, then the request
    returns its tokens so far; an expired request does not even prefill."""
    now = [0.0]

    def tick(_):
        now[0] += 1.0

    session = DecodeSession(model, chunk=4, clock=lambda: now[0])
    res = session.run(DecodeRequest(_prompt(), NEW, GREEDY, seed=21, deadline_ms=2500),
                      on_chunk=tick)
    assert res.status == "deadline" and res.new_tokens == 8 and res.tokens.shape == (2, 8)
    ref = _run(model, GREEDY)
    np.testing.assert_array_equal(res.tokens, ref.tokens[:, :8])
    late = session.run(DecodeRequest(_prompt(), NEW, GREEDY), deadline_at=now[0] - 1)
    assert late.status == "deadline" and late.new_tokens == 0 and late.chunks == 0
    with pytest.raises(ValueError, match="max_seq_len"):
        session.run(DecodeRequest(_prompt(), 200, GREEDY))


def test_inject_copy_delivers_as_the_jax_package():
    """The same plan, fired and consumed in the same order, delivers the
    same faults in the port's trimmed ``inject`` and in the JAX package's;
    an unknown site is refused by both."""
    logs = []
    for mod in (inject, jax_inject):
        plan = mod.FaultPlan().poison_decode_state_at(2, times=2).add("serve.chunk", 1, 2)
        seen = []
        with mod.inject(plan):
            for chunk in range(4):
                mod.fire("serve.chunk", step=chunk)
                for _ in range(3):
                    seen.append(mod.decode_nan_armed(chunk))
        logs.append((seen, plan.delivered))
        with pytest.raises(ValueError, match="unknown"):
            mod.FaultPlan().add("serve.chunkk")
    assert logs[0] == logs[1]


def test_flight_copy_records_as_the_jax_package():
    clock = iter(range(100)).__next__
    ours, theirs = flight.FlightRecorder(capacity=3, clock=clock), jax_flight.FlightRecorder(
        capacity=3, clock=iter(range(100)).__next__)
    for rec in (ours, theirs):
        for i in range(5):
            rec.record("ladder", rung=f"r{i}", chunk=i)
        rec.record("other")
    assert ours.events() == theirs.events() and ours.dropped == theirs.dropped == 3
    assert ours.events("ladder") == theirs.events("ladder")
