"""The port's ``SlotEngine`` (``orion_tpu_torch/serving/batching.py``) on the
CPU, at the in-scan suite's tiny widths (one linear, one softmax and one
swa layer):

- against the JAX package's ``SlotEngine``: the same greedy requests,
  admitted one a boundary into 4 slots, by host prefill and in-scan: tokens
  equal, the decoding rows' states within 1e-4 after every boundary;
- the reference's engine-level contracts, bitwise inside the port (each
  request's tokens against the port's one-row ``generate`` at its seed):
  batched == solo at slots 2, 4, 8, greedy and sampled, with late
  admission; in-scan == host prefill, staggered; the per-slot ladder
  (rewind, re-prefill, a restarted in-scan prefill, exhausted) with the
  other slots untouched; per-slot deadlines, mid-prefill too; a session
  suspended after an in-scan turn and resumed; refused requests; the
  prompt-overflow error and clamp; ``parse_buckets``; occupancy;
- C1: a decode step's products at ``DECODE_ROWS`` rows make a row of a
  4-row step bitwise its one-row step, for every product family (dense,
  norms, heads tied and untied, int8 and int4 layers, phi's projection,
  (S, z) and the caches), op by op (``utils/row_probe.py``); at the batch's
  own rows the CPU's fp32 products differ.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.serving import DecodeRequest as JaxDecodeRequest
from orion_tpu.serving import SlotEngine as JaxSlotEngine
from orion_tpu_torch import generate as gen
from orion_tpu_torch.models import transformer
from orion_tpu_torch.models.transformer import (TransformerLM, init_decode_state,
                                                insert_decode_slot)
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.serving import DecodeRequest, SlotEngine, parse_buckets
from orion_tpu_torch.utils.row_probe import row_variant_ops
from torch_serving_common import (CFG, GREEDY, SAMPLED, assert_states_close, jax_model,
                                  jax_params, jax_sample, np_states, prompt, torch_model)

torch.set_num_threads(2)
BUCKETS = (8, 16, 32)


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _engine(model, mode, slots=2, chunk=4, **kw):
    return SlotEngine(model, slots=slots, chunk=chunk, prefill_buckets=BUCKETS,
                      prefill_chunk=8 if mode == "inscan" else 0, device="cpu", **kw)


def _drain(eng):
    done = {}
    while eng.busy:
        done.update(dict(eng.step()))
    return done


def _solo(model, p, new, sample, seed):
    return gen.generate(model, torch.from_numpy(p), new, sample, seed).numpy()


def _prompts(n):
    """Prompts of 3..7 tokens: the slots sit at different positions."""
    return [prompt(100 + i, 3 + i % 5) for i in range(n)]


def _staggered(eng, requests, one_per_boundary=True):
    """Serve ``requests`` (tag, DecodeRequest), admitting into free slots at
    each boundary (one a boundary, or as many as are free) -> results by tag."""
    done, pending = {}, list(requests)
    while pending or eng.busy:
        while pending and eng.has_free_slot:
            tag, req = pending.pop(0)
            eng.admit(req, tag=tag)
            if one_per_boundary:
                break
        done.update(dict(eng.step()))
    return done


# -- against the JAX package's SlotEngine ------------------------------------


@pytest.mark.parametrize("mode", ["host", "inscan"])
def test_engine_matches_the_jax_engine(model, mode):
    """Greedy, 5 requests admitted one a boundary into 4 slots (prompts in
    two buckets): after every boundary the decoding rows' states within
    1e-4 of the JAX engine's (the caches at their positions < t), and every
    request's tokens equal."""
    lengths = [3, 8, 9, 13, 5]
    prompts = [prompt(i, n) for i, n in enumerate(lengths)]
    jeng = JaxSlotEngine(jax_model(), jax_params(), slots=4, chunk=4, prefill_buckets=BUCKETS,
                         prefill_chunk=8 if mode == "inscan" else 0)
    eng = _engine(model, mode, slots=4)
    jdone, done, pending = {}, {}, list(enumerate(prompts))
    while pending or eng.busy:
        if pending and eng.has_free_slot:
            i, p = pending.pop(0)
            eng.admit(DecodeRequest(p, 8, GREEDY, seed=i), tag=i)
            jeng.admit(JaxDecodeRequest(prompt=jnp.asarray(p, jnp.int32), max_new_tokens=8,
                                        sample=jax_sample(GREEDY), seed=i), tag=i)
        done.update(dict(eng.step()))
        jdone.update(dict(jeng.step()))
        assert sorted(done) == sorted(jdone)
        rows = [j for j, s in enumerate(eng._slots) if s is not None and s.prompt_remaining == 0]
        jt = np.asarray(jeng._carry[2])
        assert eng._carry[2][rows].tolist() == jt[rows].tolist()
        ref = [{k: v[rows] for k, v in st.items()} for st in np_states(jeng._carry[1])]
        assert_states_close(eng._carry[1], ref, rows=rows, lengths=[int(jt[j]) for j in rows])
    assert sorted(done) == list(range(5))
    for i in range(5):
        assert done[i].status == jdone[i].status == "ok"
        np.testing.assert_array_equal(done[i].tokens, np.asarray(jdone[i].tokens),
                                      err_msg=f"{mode} request {i}")


# -- batched == solo, bitwise ------------------------------------------------


@pytest.mark.parametrize("slots", [2, 4, 8])
@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_batched_parity_bitwise(model, slots, sample):
    """slots + 2 requests, the late ones admitted into freed slots while the
    others sit at nonzero positions: every request's tokens bitwise its
    one-row ``generate`` at its seed (``test_batching.py`` :101)."""
    prompts = _prompts(slots + 2)
    eng = SlotEngine(model, slots=slots, chunk=4, device="cpu")
    done = _staggered(eng, [(i, DecodeRequest(p, 8, sample, seed=500 + i))
                            for i, p in enumerate(prompts)], one_per_boundary=False)
    for i, p in enumerate(prompts):
        assert done[i].status == "ok", i
        np.testing.assert_array_equal(done[i].tokens, _solo(model, p, 8, sample, 500 + i),
                                      err_msg=f"slots={slots} request {i}")


def test_late_admission_and_eos_bitwise(model):
    """A request alone for 2 chunks, then another admitted mid-stream; and a
    request whose EOS (its 3rd greedy token) frees its slot early, its tail
    PAD: each bitwise its one-row walk."""
    a, b = _prompts(2)
    eng = SlotEngine(model, slots=4, chunk=4, device="cpu")
    eng.admit(DecodeRequest(a, 16, SAMPLED, seed=500), tag="a")
    done = {}
    for _ in range(2):
        done.update(dict(eng.step()))
    assert not done
    eng.admit(DecodeRequest(b, 8, SAMPLED, seed=501), tag="b")
    done.update(_drain(eng))
    np.testing.assert_array_equal(done["a"].tokens, _solo(model, a, 16, SAMPLED, 500))
    np.testing.assert_array_equal(done["b"].tokens, _solo(model, b, 8, SAMPLED, 501))
    eos = dataclasses.replace(GREEDY, eos_token=int(_solo(model, a, 12, GREEDY, 7)[0, 2]))
    eng = SlotEngine(model, slots=2, chunk=4, device="cpu")
    eng.admit(DecodeRequest(a, 12, eos, seed=7), tag="r")
    steps, done = 0, {}
    while eng.busy:
        done.update(dict(eng.step()))
        steps += 1
    assert steps < 3, "EOS at token 3 frees the slot before chunk 3"
    np.testing.assert_array_equal(done["r"].tokens, _solo(model, a, 12, eos, 7))


# -- in-scan == host prefill, bitwise ------------------------------------------


@pytest.mark.parametrize("slots", [2, 4, 8])
@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_inscan_bitwise_equals_host_prefill_staggered(model, slots, sample):
    """One admission a boundary, prompts straddling the buckets (8 / 16) and
    the pieces' and linear chunk's edges: in-scan and host-prefill
    admission give every request the tokens of its one-row walk
    (``test_prefill_inscan.py`` :141)."""
    lengths = [3, 8, 9, 16, 17, 21][:slots + 2]
    prompts = [prompt(i, n) for i, n in enumerate(lengths)]
    for mode in ("host", "inscan"):
        done = _staggered(_engine(model, mode, slots=slots),
                          [(i, DecodeRequest(p, 8, sample, seed=500 + i))
                           for i, p in enumerate(prompts)])
        for i, p in enumerate(prompts):
            assert done[i].status == "ok", (mode, i)
            np.testing.assert_array_equal(done[i].tokens, _solo(model, p, 8, sample, 500 + i),
                                          err_msg=f"{mode} slots={slots} request {i}")


# -- the per-slot ladder ---------------------------------------------------------


def _admit_all(eng, prompts, new=8, seed0=500, sample=GREEDY):
    for i, p in enumerate(prompts):
        eng.admit(DecodeRequest(p, new, sample, seed=seed0 + i), tag=i)


def test_poison_slot_k_rewinds_bitwise_others_untouched(model):
    prompts = _prompts(3)
    eng = SlotEngine(model, slots=4, chunk=4, device="cpu")
    _admit_all(eng, prompts)
    plan = inject.FaultPlan().poison_decode_slot_at(1, chunk=1)
    with inject.inject(plan):
        done = _drain(eng)
    assert plan.delivered == ["decode.slot_nan.1@1"]
    for i, p in enumerate(prompts):
        assert done[i].status == "ok"
        np.testing.assert_array_equal(done[i].tokens, _solo(model, p, 8, GREEDY, 500 + i))
    assert (done[1].rewinds, done[1].reprefills) == (1, 0)
    assert done[0].rewinds == 0 and done[2].rewinds == 0


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_poison_slot_escalates_to_reprefill_bitwise(model, sample):
    """Two deliveries poison the rewind's retry too: slot 1 is rebuilt from
    its prompt + emitted tokens at its position and key fold, and still
    comes out bitwise; its neighbour untouched."""
    prompts = _prompts(2)
    eng = SlotEngine(model, slots=2, chunk=4, device="cpu")
    _admit_all(eng, prompts, sample=sample)
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(1, chunk=1, times=2)):
        done = _drain(eng)
    assert done[1].status == "ok" and (done[1].rewinds, done[1].reprefills) == (1, 1)
    assert done[0].rewinds == 0
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(done[i].tokens, _solo(model, p, 8, sample, 500 + i))


def test_exhausted_ladder_fails_one_slot_others_stream(model):
    prompts = _prompts(2)
    eng = SlotEngine(model, slots=2, chunk=4, device="cpu")
    _admit_all(eng, prompts)
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(0, chunk=1, times=-1)):
        done = _drain(eng)
    refs = [_solo(model, p, 8, GREEDY, 500 + i) for i, p in enumerate(prompts)]
    assert done[0].status == "failed" and done[0].new_tokens == 4
    np.testing.assert_array_equal(done[0].tokens, refs[0][:, :4])
    assert done[1].status == "ok"
    np.testing.assert_array_equal(done[1].tokens, refs[1])
    # the poisoned row is overwritten by the next admission
    eng.admit(DecodeRequest(prompts[0], 8, GREEDY, seed=500), tag="again")
    done = _drain(eng)
    assert done["again"].status == "ok"
    np.testing.assert_array_equal(done["again"].tokens, refs[0])


def test_rewind_during_neighbour_prefill_bitwise(model):
    """Rung 1 on a decoding slot while its neighbour is mid-prefill: the
    rewound boundary replays the neighbour's piece."""
    p0, p1 = prompt(10, 5), prompt(11, 30)
    eng = _engine(model, "inscan")
    eng.admit(DecodeRequest(p0, 8, GREEDY, seed=500), tag=0)
    done = dict(eng.step())
    eng.admit(DecodeRequest(p1, 8, GREEDY, seed=501), tag=1)
    plan = inject.FaultPlan().poison_decode_slot_at(0, chunk=1)
    with inject.inject(plan):
        done.update(_drain(eng))
    assert plan.delivered == ["decode.slot_nan.0@1"]
    assert done[0].rewinds == 1 and done[0].status == "ok"
    assert done[1].status == "ok" and done[1].rewinds == 0
    for i, p in enumerate((p0, p1)):
        np.testing.assert_array_equal(done[i].tokens, _solo(model, p, 8, GREEDY, 500 + i))


def test_reprefill_rung_restarts_midprefill_slot_bitwise(model):
    """Rungs 1 and 2 on a slot still mid-prefill: rung 2 restarts its
    in-scan prefill from a zero row; its tokens still bitwise."""
    p0, p1 = prompt(20, 5), prompt(21, 30)
    eng = _engine(model, "inscan")
    eng.admit(DecodeRequest(p0, 8, GREEDY, seed=600), tag=0)
    eng.admit(DecodeRequest(p1, 8, GREEDY, seed=601), tag=1)
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(1, chunk=1, times=2)):
        done = _drain(eng)
    assert (done[1].rewinds, done[1].reprefills) == (1, 1) and done[0].rewinds == 0
    for i, p in enumerate((p0, p1)):
        assert done[i].status == "ok", i
        np.testing.assert_array_equal(done[i].tokens, _solo(model, p, 8, GREEDY, 600 + i))


# -- deadlines -------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["host", "inscan"])
def test_per_slot_deadline_evicts_one_slot_others_stream(model, mode):
    """A deadline expiring mid-batch evicts that slot with its tokens so far
    (a bitwise prefix; none while it is still mid-prefill); the other
    request runs to its end."""
    p0, p1 = prompt(30, 5), prompt(31, 30 if mode == "inscan" else 6)
    now = [0.0]
    eng = _engine(model, mode, clock=lambda: now[0])
    eng.admit(DecodeRequest(p0, 12, GREEDY, seed=700), tag="slow")
    eng.admit(DecodeRequest(p1, 12, GREEDY, seed=701), tag="tight", deadline_at=1.5)
    done = {}
    while eng.busy:
        done.update(dict(eng.step()))
        now[0] += 1.0
    assert done["tight"].status == "deadline"
    if mode == "inscan":  # still mid-prefill at expiry
        assert done["tight"].new_tokens == 0
    else:  # 2 chunks before the t = 2.0 boundary
        assert done["tight"].new_tokens == 8
        np.testing.assert_array_equal(done["tight"].tokens,
                                      _solo(model, p1, 12, GREEDY, 701)[:, :8])
    assert done["slow"].status == "ok"
    np.testing.assert_array_equal(done["slow"].tokens, _solo(model, p0, 12, GREEDY, 700))


# -- sessions ----------------------------------------------------------------------


def test_session_suspend_resume_across_inscan_admission(model):
    """A session's first turn admitted in-scan is suspended at its end and
    resumed for turn 2 (an empty prompt, no prefill): the two turns are
    bitwise one uninterrupted request. A second resume picks up the
    chunk's overshoot: turn lengths that are no multiple of the chunk."""
    p = prompt(40, 21)  # 3 pieces of 8
    ref = _solo(model, p, 24, SAMPLED, 900)
    eng = _engine(model, "inscan")
    eng.admit(DecodeRequest(p, 8, SAMPLED, seed=900, session_id="s"), tag=1)
    r1 = _drain(eng)[1]
    assert r1.status == "ok" and r1.session is not None and r1.session.buffered == 0
    np.testing.assert_array_equal(r1.tokens, ref[:, :8])
    empty = np.zeros((1, 0), np.int64)
    eng.resume(r1.session, DecodeRequest(empty, 6, SAMPLED, seed=900, session_id="s"), tag=2)
    r2 = _drain(eng)[2]  # two chunks of 4: 2 tokens left over
    np.testing.assert_array_equal(r2.tokens, ref[:, 8:14])
    assert r2.session.buffered == 2
    eng.resume(r2.session, DecodeRequest(empty, 10, SAMPLED, seed=900, session_id="s"), tag=3)
    r3 = _drain(eng)[3]
    np.testing.assert_array_equal(r3.tokens, ref[:, 14:24])
    # suspend_sessions mid-stream, then resume: the same tokens again
    eng.admit(DecodeRequest(p, 16, SAMPLED, seed=900, session_id="t"), tag=4)
    for _ in range(3):  # pieces of 8, 8 and 5, the last with a chunk of 4 tokens
        assert not eng.step()
    (tag, mid), = eng.suspend_sessions()
    assert tag == 4 and mid.status == "suspended" and mid.new_tokens == 4
    assert not eng.busy
    eng.resume(mid.session, DecodeRequest(empty, 12, SAMPLED, seed=900, session_id="t"), tag=5)
    r5 = _drain(eng)[5]
    np.testing.assert_array_equal(np.concatenate([mid.tokens, r5.tokens], 1), ref[:, :16])


def test_session_resume_reprefill_rung_bitwise(model):
    """The re-prefill rung of a resumed session rebuilds from the prompt and
    every token of both turns, at the carry's key fold."""
    p = prompt(41, 6)
    ref = _solo(model, p, 16, SAMPLED, 901)
    eng = SlotEngine(model, slots=2, chunk=4, device="cpu")
    eng.admit(DecodeRequest(p, 8, SAMPLED, seed=901, session_id="s"), tag=1)
    r1 = _drain(eng)[1]
    eng.resume(r1.session, DecodeRequest(np.zeros((1, 0), np.int64), 8, SAMPLED, seed=901),
               tag=2)
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(0, chunk=1, times=2)):
        r2 = _drain(eng)[2]
    assert (r2.rewinds, r2.reprefills) == (1, 1)
    np.testing.assert_array_equal(np.concatenate([r1.tokens, r2.tokens], 1), ref)


def test_drain_evict_all_and_failed_never_suspends(model):
    eng = SlotEngine(model, slots=2, chunk=4, device="cpu")
    eng.admit(DecodeRequest(prompt(42, 5), 8, GREEDY, session_id="s"), tag="a")
    eng.step()
    (tag, r), = eng.drain_evict_all()
    assert tag == "a" and r.status == "failed" and r.new_tokens == 4 and r.session is None
    assert not eng.busy


# -- refusals and the buckets --------------------------------------------------------


def test_mismatched_sample_config_and_multirow_prompt_are_isolated_errors(model):
    """A request with another SampleConfig than the resident batch's, or a
    batch of rows, is refused at admission; the resident request is
    unaffected (``test_batching.py`` :436, :455)."""
    p = _prompts(1)[0]
    eng = SlotEngine(model, slots=4, chunk=4, device="cpu")
    eng.admit(DecodeRequest(p, 8, GREEDY, seed=500), tag="good")
    with pytest.raises(ValueError, match="SampleConfig"):
        eng.admit(DecodeRequest(prompt(101, 4), 8, SAMPLED, seed=501))
    with pytest.raises(ValueError, match="one sequence per request"):
        eng.admit(DecodeRequest(np.ones((2, 4), np.int64), 4, GREEDY))
    assert eng.active_count == 1
    done = _drain(eng)
    np.testing.assert_array_equal(done["good"].tokens, _solo(model, p, 8, GREEDY, 500))


@pytest.mark.parametrize("mode", ["inscan", "host"])
def test_prompt_overflow_is_a_clean_error(model, mode):
    eng = _engine(model, mode)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        eng.admit(DecodeRequest(prompt(0, BUCKETS[-1] + 5), 4, GREEDY))
    assert not eng.busy, "the refused request holds no slot"


def test_prompt_overflow_clamp_serves_newest_context(model):
    long_prompt = prompt(1, BUCKETS[-1] + 7)
    eng = _engine(model, "inscan", prompt_overflow="clamp")
    eng.admit(DecodeRequest(long_prompt, 8, GREEDY, seed=11), tag="r")
    done = _drain(eng)
    np.testing.assert_array_equal(done["r"].tokens,
                                  _solo(model, long_prompt[:, -BUCKETS[-1]:], 8, GREEDY, 11))
    # max_new 70: bucket 32 no longer fits under the cap 96, so 16 is taken
    eng2 = _engine(model, "inscan", prompt_overflow="clamp")
    i = eng2.admit(DecodeRequest(long_prompt, 70, GREEDY, seed=12), tag="r2")
    assert eng2._slots[i].prompt.shape[1] == 16
    with pytest.raises(ValueError, match="no bucket leaves room"):
        eng2.admit(DecodeRequest(long_prompt, 95, GREEDY, seed=13))


def test_inscan_requires_buckets_and_rounds_to_the_chunk(model):
    with pytest.raises(ValueError, match="prefill_buckets"):
        SlotEngine(model, slots=2, chunk=4, prefill_chunk=8, device="cpu")
    eng = SlotEngine(model, slots=2, chunk=4, prefill_chunk=6, prefill_buckets=BUCKETS,
                     device="cpu")
    assert (eng.prefill_chunk, eng.chunk_align) == (8, CFG.chunk)


def test_parse_buckets():
    assert parse_buckets("", 512) == ()
    assert parse_buckets("off", 512) == ()
    assert parse_buckets("pow2", 512) == (16, 32, 64, 128, 256, 512)
    assert parse_buckets("pow2", 48) == (16, 32, 48)
    assert parse_buckets("32,8,64", 64) == (8, 32, 64)
    with pytest.raises(ValueError):
        parse_buckets("128", 64)
    assert gen.bucket_for(9, (8, 16)) == 16
    assert gen.bucket_for(99, (8, 16)) is None


def test_occupancy_distinguishes_prefilling_from_decoding(model):
    eng = _engine(model, "inscan")
    eng.admit(DecodeRequest(prompt(60, 5), 8, GREEDY, seed=0), tag=0)
    eng.admit(DecodeRequest(prompt(61, 30), 8, GREEDY, seed=1), tag=1)
    occ = eng.occupancy()
    assert occ["active"] == 2 and occ["prefilling"] == 2  # nothing consumed yet
    eng.step()
    occ = eng.occupancy()
    assert occ["prefilling"] == 1 and occ["decoding"] == 1
    assert [phase for _, _, phase, _ in eng.slot_info()] == ["decode", "prefill"]
    _drain(eng)
    occ = eng.occupancy()
    assert occ["prefilling"] == 0 and occ["active"] == 0


def test_events_and_last_boundary(model):
    events = []
    eng = _engine(model, "inscan", on_event=lambda kind, f: events.append((kind, f)))
    eng.admit(DecodeRequest(prompt(62, 12), 4, GREEDY), tag="x")
    eng.step()  # the first piece of 8
    assert eng.last_boundary == [{"slot": 0, "tag": "x", "decode_steps": 0,
                                  "prefill_tokens": 8, "decode_tokens": 0}]
    eng.step()  # the last 4 prompt tokens, then a chunk of 4
    assert eng.last_boundary[0]["prefill_tokens"] == 4
    assert eng.last_boundary[0]["decode_tokens"] == 4
    kinds = [k for k, _ in events]
    assert kinds == ["admit", "prefill_piece", "prefill_piece", "evict"]


# -- C1: a decode step's rows do not depend on the batch ------------------------------


def _family(name):
    """(model, compute dtype) of each product family on the tiny widths."""
    cfg = CFG
    if name == "learnable untied int8":
        cfg = dataclasses.replace(CFG, feature_map="learnable", tie_embeddings=False)
    if name != "fp32":
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    if name == "fp32":
        return torch_model()
    m = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    m = gen.cast_params_for_inference(m)
    quant = {"int8": "int8", "int4": "int4", "learnable untied int8": "int8"}.get(name)
    return gen.quantize_for_decode(m, quant) if quant else m


def _batch(model, slots=4):
    states = init_decode_state(model.cfg, slots, "cpu")
    toks, ts = [], []
    for j in range(slots):
        c = gen.prefill_carry(model, torch.from_numpy(prompt(70 + j, 5 + 3 * j)), GREEDY,
                              gen.request_keys(j, 1))
        insert_decode_slot(states, c[1], j)
        toks.append(c[0])
        ts.append(c[2])
    return torch.cat(toks), states, torch.tensor(ts)


@pytest.mark.parametrize("family", ["fp32", "bf16", "int8", "int4", "learnable untied int8"])
def test_decode_rows_make_a_row_bitwise_its_one_row_step(family):
    model = _family(family)
    tok, states, t = _batch(model)
    for row in (0, 2):
        r = row_variant_ops(model, tok, states, t, row)
        assert r["misaligned"] is None
        assert r["culprits"] == [] and r["first_differs"] is None, (family, row, r)
        assert r["logits_equal"] and r["states_equal"]


def test_the_batch_own_rows_differ_on_the_cpu(monkeypatch):
    """The probe's control: with the products at the batch's own rows the
    CPU's fp32 dense products round a row by the row count."""
    model = _family("fp32")
    tok, states, t = _batch(model)
    monkeypatch.setattr(transformer, "DECODE_ROWS", 1)
    r = row_variant_ops(model, tok, states, t, 2)
    assert r["misaligned"] is None and r["culprits"]
    assert not r["logits_equal"]
    assert {o["op"] for o in r["culprits"]} <= {"aten.linear", "aten.matmul", "aten.mm"}


def test_a_scalar_position_with_a_write_mask_is_the_vector_one(model):
    """The padded step with one position for all rows and a write mask: the
    position broadcast over the state's rows, not the padded ones."""
    tok, states, _ = _batch(model, 3)
    write = torch.tensor([True, False, True])
    with torch.inference_mode():
        a = model.decode_step(tok, transformer.snapshot_decode_state(states), 30, write)
        b = model.decode_step(tok, transformer.snapshot_decode_state(states),
                              torch.full((3,), 30), write)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a[1], b[1]) for k in x)
