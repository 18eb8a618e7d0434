"""Self-speculative decode in the port (``TransformerLM.draft_step``,
``verify_step``, ``advance_verified_states``, ``generate.
decode_batched_spec_round``, ``SlotEngine(spec_depth=...)``, the Server and
its CLI) on the CPU, at the JAX suite's config (``tests/test_spec_decode.py``:
one linear, one softmax and one swa layer, window 4, max_seq_len 64, fp32),
its params drawn with numpy:

- against the JAX package, fp32, within 1e-4 of each tensor's largest
  magnitude: ``verify_step``'s logits, ``advance_verified_states``' states
  at every keep, ``draft_step``'s logits and states, and one greedy
  ``decode_batched_spec_round``'s emitted tokens and accepted counts
  (equal) with its states;
- the reference suite's contracts, bitwise inside the port (each request
  against the port's one-row ``generate`` at its seed), cited by line of
  ``tests/test_spec_decode.py``: the verify piece is the decode walk; the
  draft reads no cache; spec == plain at slots 1, 4, 8, greedy and sampled,
  full precision, int8 and int4; in-scan prefill; rounds interleaved with
  plain boundaries; the ladder (rewind, re-prefill, exhausted) mid-
  speculation; a SIGTERM mid-speculation suspended and resumed; a spec
  Server resuming a plain Server's session; the adaptive floor; the guards;
  the ``speculation`` section;
- the cause of C1 on the card: every product of ``verify_step`` and
  ``draft_step`` at ``DECODE_ROWS`` rows, at 4 slots x depth 3 and at 20
  slots x depth 3 (two blocks of 64), and at the piece's own row count when
  ``verify_rows`` is undone;
- a round straddling ``max_seq_len`` on the softmax layer; one host read a
  speculative boundary; in place of the JAX suite's two XLA-only tests
  (compiles, jaxpr carries): a round's carry is slots x the per-slot state,
  and a speculating engine never runs the plain chunk while no slot is
  floored.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.generate import SampleConfig as JaxSampleConfig
from orion_tpu.generate import decode_batched_spec_round as jax_spec_round
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu.serving import DecodeRequest as JaxDecodeRequest
from orion_tpu.serving import SlotEngine as JaxSlotEngine
from orion_tpu_torch import generate as gen
from orion_tpu_torch.convert import expected_params, load_jax_params
from orion_tpu_torch.models import transformer
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.models.transformer import (DECODE_ROWS, TransformerLM, insert_decode_slot,
                                                linear_layer_indices, snapshot_decode_state)
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.serving import (DecodeRequest, Health, ServeConfig, Server, SlotEngine,
                                     parse_buckets)
from orion_tpu_torch.serving import batching
from orion_tpu_torch.serving.__main__ import main as cli_main
from orion_tpu_torch.utils.row_probe import product_rows

torch.set_num_threads(2)

_KW = dict(name="batch_test", vocab_size=64, d_model=32, n_layers=3, n_heads=2,
           layer_types=("linear", "softmax", "swa"), window=4, max_seq_len=64, dtype="float32")
CFG = ModelConfig(**_KW)
JAX_CFG = JaxModelConfig(**_KW, backend="xla")
GREEDY = gen.SampleConfig(temperature=0.0)
SAMPLED = gen.SampleConfig(temperature=0.8, top_k=5, top_p=0.9, eos_token=3, pad_token=0)
DEPTH = 3
# fp32 on both sides: within 1e-4 of the reference's largest magnitude
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _tree():
    """A flax param tree for CFG drawn with numpy at the flax init scales,
    norm scales around 1."""
    rng = np.random.default_rng(0)
    out = {}
    for path, (_, shape, transpose) in expected_params(CFG).items():
        shape = shape[::-1] if transpose else shape
        arr = (1.0 + 0.1 * rng.standard_normal(shape) if path.endswith("scale") else
               rng.standard_normal(shape) / np.sqrt(shape[0] if transpose else shape[1]))
        node = out
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": out}


@pytest.fixture(scope="module")
def model():
    return load_jax_params(TransformerLM(CFG, device="cpu"), _tree())


class _JaxMethods:
    """The JAX model's methods under ``jax.jit`` (eagerly each traced
    ``lax.scan`` costs seconds)."""

    def __init__(self):
        self.model, self.params = JaxLM(JAX_CFG), jax.tree.map(jnp.asarray, _tree())
        for name in ("prefill_last", "verify_step", "advance_verified_states", "draft_step"):
            setattr(self, name, jax.jit(functools.partial(self.model.apply, self.params,
                                                          method=name)))


@pytest.fixture(scope="module")
def jax_mp():
    return _JaxMethods()


def _prompts(n):
    """Prompts of 3..7 tokens, so the slots sit at different positions."""
    return [np.random.default_rng(1000 + i).integers(0, CFG.vocab_size, (1, 3 + i % 5))
            for i in range(n)]


def _solo(model, p, new, sample, seed):
    return gen.generate(model, torch.from_numpy(p), new, sample, seed).numpy()


def _spec_cfg(**kw):
    base = dict(chunk=4, slots=4, max_inflight=8, spec_depth=DEPTH, spec_min_accept=0.0,
                prefill_buckets="off", prefill_chunk=0)
    base.update(kw)
    return ServeConfig(**base)


def _drain(eng, requests=(), one_per_boundary=False):
    """Admit ``requests`` (tag, DecodeRequest) into free slots at each
    boundary and step until idle -> results by tag."""
    done, pending = {}, list(requests)
    while pending or eng.busy:
        while pending and eng.has_free_slot:
            tag, req = pending.pop(0)
            eng.admit(req, tag=tag)
            if one_per_boundary:
                break
        done.update(dict(eng.step()))
    return done


def _batch(model, slots, prompt_len=8):
    """``slots`` prompts prefilled as one batch: (states, positions [S])."""
    p = np.random.default_rng(2).integers(0, CFG.vocab_size, (slots, prompt_len))
    with torch.inference_mode():
        _, states = model.prefill_last(torch.from_numpy(p))
    return p, states, torch.full((slots,), prompt_len)


def _close(got, ref, what):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=TOL, atol=TOL * scale, err_msg=what)


def _states_close(got, ref, what):
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in r:
            _close(g[k], r[k], f"{what}: layer {i} {k}")


def _equal_states(a, b, row=None):
    sel = (lambda x: x) if row is None else (lambda x: x[row])
    return all(torch.equal(sel(x[k]), sel(y[k])) for x, y in zip(a, b) for k in x)


# -- against the JAX package, fp32 ----------------------------------------------------


def test_verify_and_advance_match_the_jax_package(model, jax_mp):
    """``verify_step``'s logits [4, 4, V] and, at every uniform keep and a
    mixed one, ``advance_verified_states``' states, within 1e-4 of the JAX
    package's."""
    p, states, t = _batch(model, 4)
    _, jstates = jax_mp.prefill_last(jnp.asarray(p, jnp.int32))
    fed = np.random.default_rng(3).integers(0, CFG.vocab_size, (4, DEPTH + 1))
    jt = jnp.asarray(t.numpy(), jnp.int32)
    jlogits, jupds = jax_mp.verify_step(jnp.asarray(fed, jnp.int32), jstates, jt)
    keeps = [np.full(4, k) for k in range(DEPTH + 2)] + [np.array([0, 1, 3, 4])]
    for keep in keeps:
        with torch.inference_mode():
            st = snapshot_decode_state(states)
            logits, upds = model.verify_step(torch.from_numpy(fed), st, t)
            got = model.advance_verified_states(st, upds, t, torch.from_numpy(keep))
        _close(logits, jlogits, "verify_step logits")
        ref = jax_mp.advance_verified_states(jstates, jupds, jt, jnp.asarray(keep, jnp.int32))
        _states_close(got, ref, f"advance_verified_states keep={keep.tolist()}")


def test_draft_step_matches_the_jax_package(model, jax_mp):
    """Three draft steps on the linear layer's (S, z): logits and states
    within 1e-4."""
    p, states, t = _batch(model, 2)
    _, jstates = jax_mp.prefill_last(jnp.asarray(p, jnp.int32))
    lin = linear_layer_indices(CFG)
    assert lin == (0,)
    lst, jlst = [states[i] for i in lin], [jstates[i] for i in lin]
    tok = np.array([1, 5])
    for j in range(3):
        with torch.inference_mode():
            lg, lst = model.draft_step(torch.from_numpy(tok), lst, t + j)
        jlg, jlst = jax_mp.draft_step(jnp.asarray(tok, jnp.int32), jlst,
                                      jnp.asarray(t.numpy() + j, jnp.int32))
        _close(lg, jlg, f"draft_step {j} logits")
        _states_close(lst, jlst, f"draft_step {j}")
        tok = np.asarray(jlg).argmax(-1)


def test_spec_round_matches_the_jax_package(model, jax_mp):
    """One greedy ``decode_batched_spec_round`` over 4 slots (one inactive,
    one not speculating): emitted tokens, accepted counts, the next tokens,
    positions and emit indices equal; the states within 1e-4."""
    p, states, t = _batch(model, 4)
    jlogits, jstates = jax_mp.prefill_last(jnp.asarray(p, jnp.int32))
    token = np.asarray(jlogits).argmax(-1)
    with torch.inference_mode():
        logits, _ = model.prefill_last(torch.from_numpy(p))
    assert logits.argmax(-1).tolist() == token.tolist()
    active = np.array([True, True, False, True])
    spec_on = np.array([True, True, True, False])
    emit = np.zeros(4, np.int64)
    done = np.zeros(4, bool)
    jcarry = (jnp.asarray(token, jnp.int32), jstates, jnp.asarray(t.numpy(), jnp.int32),
              jnp.asarray(emit, jnp.int32), jnp.asarray(done))
    jout, jemitted, jn = jax_spec_round(jax_mp.model, jax_mp.params, jcarry, jnp.zeros((4, 2), jnp.uint32),
                                       jnp.asarray(active), jnp.asarray(spec_on), DEPTH,
                                       JaxSampleConfig(temperature=0.0))
    carry = (torch.from_numpy(token), states, t.clone(), torch.from_numpy(emit),
             torch.from_numpy(done))
    out, emitted, n = gen.decode_batched_spec_round(
        model, carry, gen.request_keys(0, 4), torch.from_numpy(active),
        torch.from_numpy(spec_on), DEPTH, GREEDY)
    assert emitted.tolist() == np.asarray(jemitted).tolist()
    assert n.tolist() == np.asarray(jn).tolist()
    for k in (0, 2, 3):
        assert out[k].tolist() == np.asarray(jout[k]).tolist(), k
    _states_close(out[1], jout[1], "spec round states")


# -- the verify piece is the decode walk (tests/test_spec_decode.py :110) ----------------


@pytest.mark.parametrize("slots", [4, 20])
def test_verify_step_bitwise_vs_sequential_decode(model, slots):
    """The contract everything rests on: ``verify_step``'s logits are
    bitwise P successive ``decode_step`` calls, and the clamped advance
    lands exactly the kept prefix's updates, per row and for any keep. 20
    slots x 4 fed tokens run as two blocks of 64 rows."""
    P = DEPTH + 1
    p, states, _ = _batch(model, slots)
    t = torch.from_numpy(np.random.default_rng(4).integers(8, 40, slots))
    with torch.inference_mode():
        for j in range(slots):  # each row at its own position
            _, one = model.prefill_last(torch.from_numpy(np.resize(p[j], (1, int(t[j])))))
            insert_decode_slot(states, one, j)
    fed = torch.from_numpy(np.random.default_rng(3).integers(0, CFG.vocab_size, (slots, P)))
    with torch.inference_mode():
        walk, ref = [snapshot_decode_state(states)], []
        st = snapshot_decode_state(states)
        for j in range(P):
            lg, st = model.decode_step(fed[:, j], st, t + j)
            ref.append(lg)
            walk.append(snapshot_decode_state(st))
        ref = torch.stack(ref, dim=1)
        keeps = [torch.full((slots,), k) for k in range(P + 1)] + [torch.arange(slots) % (P + 1)]
        for keep in keeps:
            st = snapshot_decode_state(states)
            logits, upds = model.verify_step(fed, st, t)
            assert torch.equal(logits, ref), "verify logits must be bitwise the decode walk's"
            got = model.advance_verified_states(st, upds, t, keep)
            for b in range(slots):
                assert _equal_states(got, walk[int(keep[b])], row=b), (b, keep.tolist())


def test_draft_step_runs_linear_trunk_only(model):
    """(:163) ``draft_step`` takes and returns the linear layers' (S, z)
    only, leaves them as they were, and reads no cache: NaN in every cache
    does not reach its logits."""
    _, states, t = _batch(model, 2)
    lin = linear_layer_indices(CFG)
    tok = torch.ones(2, dtype=torch.long)
    before = snapshot_decode_state([states[i] for i in lin])
    with torch.inference_mode():
        lg, new = model.draft_step(tok, [states[i] for i in lin], t)
        assert _equal_states([states[i] for i in lin], before)
        assert lg.shape == (2, CFG.vocab_size) and len(new) == 1 and set(new[0]) == {"s", "z"}
        poisoned = [st if i in lin else {k: v * float("nan") for k, v in st.items()}
                    for i, st in enumerate(states)]
        lg2, _ = model.draft_step(tok, [poisoned[i] for i in lin], t)
    assert torch.equal(lg, lg2) and bool(torch.isfinite(lg2).all())


# -- spec == plain, bitwise ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _quantized(qmode):
    m = load_jax_params(TransformerLM(CFG, device="cpu"), _tree())
    return gen.quantize_for_decode(m, qmode)


@pytest.mark.parametrize("qmode", ["off", "int8", "int4"])
@pytest.mark.parametrize("slots", [1, 4, 8])
@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_spec_parity_bitwise(model, slots, sample, qmode):
    """(:195, :503) slots + 2 requests through a speculating Server (freed
    slots refill at boundaries, so late requests join beside slots deep in
    their own rounds), full precision and quantized by the Server
    (``qmode``): every request bitwise the one-row ``generate`` of the same
    weights at its seed, and drafts were proposed."""
    served = model if qmode == "off" else _quantized(qmode)
    n = slots + 2
    prompts = _prompts(n)
    srv = Server(model, _spec_cfg(slots=slots, max_inflight=n, qmode=qmode))
    ps = [srv.submit(DecodeRequest(p, 8, sample, seed=500 + i)) for i, p in enumerate(prompts)]
    assert srv.serve(drain_when_idle=True) == 0
    for i, (pend, p) in enumerate(zip(ps, prompts)):
        assert pend.result is not None and pend.result.status == "ok", i
        np.testing.assert_array_equal(pend.result.tokens, _solo(served, p, 8, sample, 500 + i),
                                      err_msg=f"request {i}")
    flat = srv.metrics.counters_flat()
    assert flat.get("spec_accepted_total", 0) + flat.get("spec_rejected_total", 0) > 0
    srv.close()


def test_spec_parity_with_inscan_prefill(model):
    """(:226) Mid-prefill boundaries run the unified program, pure-decode
    ones the round; the interleaving leaves the tokens bitwise."""
    prompts = _prompts(4)
    eng = SlotEngine(model, slots=2, chunk=4, spec_depth=DEPTH, device="cpu",
                     prefill_buckets=parse_buckets("pow2", CFG.max_seq_len), prefill_chunk=8)
    done = _drain(eng, [(i, DecodeRequest(p, 8, GREEDY, seed=500 + i))
                        for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        assert done[i].status == "ok"
        np.testing.assert_array_equal(done[i].tokens, _solo(model, p, 8, GREEDY, 500 + i))


def test_spec_rounds_interleave_with_plain_boundaries(model):
    """(:250) The speculation mask flapped between boundaries (rounds and
    plain chunks in turn): the tokens are the same."""
    prompts = _prompts(2)
    eng = SlotEngine(model, slots=2, chunk=4, spec_depth=DEPTH, device="cpu")
    for i, p in enumerate(prompts):
        eng.admit(DecodeRequest(p, 8, GREEDY, seed=500 + i), tag=i)
    done, flip = {}, False
    while eng.busy:
        eng._spec_on_np[:] = flip
        flip = not flip
        done.update(dict(eng.step()))
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(done[i].tokens, _solo(model, p, 8, GREEDY, 500 + i))


# -- the ladder mid-speculation (:346-415) ----------------------------------------------


def _spec_engine(model, prompts, slots, **kw):
    eng = SlotEngine(model, slots=slots, chunk=4, spec_depth=DEPTH, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.admit(DecodeRequest(p, 8, GREEDY, seed=500 + i), tag=i)
    return eng


def test_spec_poisoned_slot_rewinds_bitwise(model):
    """(:346) Rung 1 at a speculative boundary: the whole round replays from
    a fresh copy of the snapshot; the poisoned slot's retry and both
    neighbours come out bitwise."""
    prompts = _prompts(3)
    eng = _spec_engine(model, prompts, 4)
    plan = inject.FaultPlan().poison_decode_slot_at(1, chunk=1)
    with inject.inject(plan):
        done = _drain(eng)
    assert plan.delivered == ["decode.slot_nan.1@1"]
    for i, p in enumerate(prompts):
        assert done[i].status == "ok"
        np.testing.assert_array_equal(done[i].tokens, _solo(model, p, 8, GREEDY, 500 + i))
    assert (done[1].rewinds, done[1].reprefills) == (1, 0)
    assert done[0].rewinds == done[2].rewinds == 0


def test_spec_poisoned_slot_escalates_to_reprefill_bitwise(model):
    """(:371) Rung 2 mid-speculation: the re-prefill rebuilds the slot from
    its prompt and the rounds' variable-length emissions (the accepted
    counts set the fold), and the walk lands bitwise."""
    prompts = _prompts(2)
    eng = _spec_engine(model, prompts, 2)
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(1, chunk=1, times=2)):
        done = _drain(eng)
    assert done[1].status == "ok" and (done[1].rewinds, done[1].reprefills) == (1, 1)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(done[i].tokens, _solo(model, p, 8, GREEDY, 500 + i))


def test_spec_exhausted_ladder_fails_one_slot_others_stream(model):
    """(:392) Every attempt poisoned for slot 0: its request fails with the
    rounds before the fault, bitwise; slot 1 streams on bitwise."""
    prompts = _prompts(2)
    eng = _spec_engine(model, prompts, 2)
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(0, chunk=1, times=-1)):
        done = _drain(eng)
    refs = [_solo(model, p, 8, GREEDY, 500 + i) for i, p in enumerate(prompts)]
    assert done[0].status == "failed" and done[0].new_tokens > 0
    np.testing.assert_array_equal(done[0].tokens, refs[0][:, :done[0].new_tokens])
    assert done[1].status == "ok"
    np.testing.assert_array_equal(done[1].tokens, refs[1])


# -- sessions mid-speculation (:417-501) ------------------------------------------------


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_sigterm_mid_speculation_suspends_and_resumes_bitwise(model, tmp_path, sample):
    """(:417) A SIGTERM while both slots speculate: the sessions suspend at
    the next round's boundary with part of their tokens, the Server exits
    0, and a restarted speculating Server resumes them: the two turns
    together are bitwise the uninterrupted one-row run."""
    want = 24
    prompts = _prompts(2)
    cfg = _spec_cfg(slots=2, session_dir=str(tmp_path / "sess"))
    srv1 = Server(model, cfg)
    ps = [srv1.submit(DecodeRequest(p, want, sample, seed=500 + i, session_id=f"user{i}"))
          for i, p in enumerate(prompts)]
    with inject.inject(inject.FaultPlan().preempt_at_chunk(2)):
        assert srv1.serve() == 0
    assert srv1.health.state is Health.DEAD
    for p in ps:
        assert p.result.status == "suspended" and 0 < p.result.new_tokens < want
    srv2 = Server(model, cfg)
    conts = [srv2.submit(DecodeRequest(np.zeros((1, 0), np.int64),
                                       want - ps[i].result.new_tokens, sample, seed=0,
                                       session_id=f"user{i}")) for i in range(2)]
    assert srv2.serve(drain_when_idle=True) == 0
    for i, p in enumerate(prompts):
        assert conts[i].result.status == "ok", i
        total = np.concatenate([ps[i].result.tokens, conts[i].result.tokens], axis=1)
        np.testing.assert_array_equal(total, _solo(model, p, want, sample, 500 + i),
                                      err_msg=f"session {i}")
    srv2.close()


def test_spec_server_resumes_plain_server_session_bitwise(model, tmp_path):
    """(:466) A conversation suspended by a plain Server resumes bitwise on a
    speculating one: the snapshot is the same carry."""
    prompt = _prompts(1)[0]
    sdir = str(tmp_path / "sess")
    srv1 = Server(model, ServeConfig(chunk=4, slots=2, max_inflight=4, session_dir=sdir,
                                     prefill_buckets="off", prefill_chunk=0))
    p1 = srv1.submit(DecodeRequest(prompt, 8, GREEDY, seed=500, session_id="conv"))
    assert srv1.serve(drain_when_idle=True) == 0 and p1.result.status == "ok"
    srv1.close()
    srv2 = Server(model, _spec_cfg(slots=2, session_dir=sdir))
    p2 = srv2.submit(DecodeRequest(np.zeros((1, 0), np.int64), 8, GREEDY, seed=0,
                                   session_id="conv"))
    assert srv2.serve(drain_when_idle=True) == 0
    srv2.close()
    np.testing.assert_array_equal(np.concatenate([p1.result.tokens, p2.result.tokens], axis=1),
                                  _solo(model, prompt, 16, GREEDY, 500))


# -- the adaptive floor (:539-607) ------------------------------------------------------


def test_adaptive_floor_scripted_adversarial_stream(model):
    """(:539) A scripted acceptance stream, strong then collapsing: the slot
    floors exactly when its EWMA crosses ``spec_min_accept`` (never on its
    first round), one ``spec_floor`` event, and stays floored."""
    events = []
    eng = SlotEngine(model, slots=2, chunk=4, spec_depth=DEPTH, spec_min_accept=0.3,
                     device="cpu", on_event=lambda k, f: events.append((k, f)))
    eng.admit(DecodeRequest(_prompts(1)[0], 32, GREEDY, seed=0), tag=0)
    ewmas = []
    for accepted in (DEPTH, DEPTH, 0, 0, 0):
        eng._update_spec_accept(0, accepted)
        ewmas.append(eng._accept_ewma[0])
    assert ewmas[:4] == [1.0, 1.0, 0.5, 0.25]
    floors = [f for k, f in events if k == "spec_floor"]
    assert len(floors) == 1 and floors[0]["slot"] == 0 and floors[0]["rounds"] == 4
    assert not eng._spec_on_np[0]
    eng2 = SlotEngine(model, slots=1, chunk=4, spec_depth=DEPTH, spec_min_accept=0.3,
                      device="cpu")
    eng2.admit(DecodeRequest(_prompts(1)[0], 32, GREEDY, seed=0), tag=0)
    eng2._update_spec_accept(0, 0)
    assert eng2._spec_on_np[0], "one unlucky round is not a trend"


def test_floored_slot_rides_plain_and_stays_bitwise(model):
    """(:574) A floor nothing passes: every slot falls back, the tokens stay
    bitwise, and after the last floor the boundaries run the plain chunk (at
    most the flooring round reports after it)."""
    prompts = _prompts(2)
    events = []
    eng = _spec_engine(model, [], 2, spec_min_accept=1.01,
                       on_event=lambda k, f: events.append((k, f)))
    done = _drain(eng, [(i, DecodeRequest(p, 12, GREEDY, seed=500 + i))
                        for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        assert done[i].status == "ok"
        np.testing.assert_array_equal(done[i].tokens, _solo(model, p, 12, GREEDY, 500 + i))
    kinds = [k for k, _ in events]
    assert kinds.count("spec_floor") == 2 and "spec_round" in kinds
    last_floor = max(i for i, k in enumerate(kinds) if k == "spec_floor")
    assert kinds[last_floor + 1:].count("spec_round") <= 1


# -- guards and bookkeeping (:609-628) --------------------------------------------------


def test_spec_depth_guards(model):
    """(:609) The JAX package's refusals: depth + 1 past the swa window, no
    linear layer, MoE."""
    with pytest.raises(ValueError, match="window"):
        SlotEngine(model, slots=2, spec_depth=CFG.window, device="cpu")
    SlotEngine(model, slots=2, spec_depth=CFG.window - 1, device="cpu")
    no_linear = TransformerLM(dataclasses.replace(CFG, layer_types=("softmax", "swa", "swa")),
                              device="cpu")
    with pytest.raises(ValueError, match="linear"):
        SlotEngine(no_linear, slots=2, spec_depth=2, device="cpu")
    moe = TransformerLM(dataclasses.replace(CFG, layer_types=None, n_experts=2, moe_period=2),
                        device="cpu")
    with pytest.raises(ValueError, match="MoE|dense"):
        SlotEngine(moe, slots=2, spec_depth=2, device="cpu")
    with pytest.raises(ValueError, match="window"):
        Server(model, _spec_cfg(spec_depth=CFG.window))


def test_spec_info_and_speculation_section(model):
    """(:627) The snapshot's speculation section: depth, floor, the
    registry's totals and each slot's view; one acceptance observation for
    the one speculating request; a flight ``spec_reject`` for each round
    that rejected drafts."""
    srv = Server(model, _spec_cfg(slots=2))
    p = srv.submit(DecodeRequest(_prompts(1)[0], 8, GREEDY, seed=0))
    assert srv.serve(drain_when_idle=True) == 0 and p.result.status == "ok"
    doc = srv.snapshot()["speculation"]
    flat = srv.metrics.counters_flat()
    assert doc["depth"] == DEPTH and doc["min_accept"] == 0.0 and doc["slots"] == []
    assert doc["accepted_total"] == flat.get("spec_accepted_total", 0)
    assert doc["rejected_total"] == flat.get("spec_rejected_total", 0)
    assert doc["accepted_total"] + doc["rejected_total"] > 0
    hists = [h for h in srv.metrics.snapshot()["histograms"] if h["name"] == "spec_accept_rate"]
    assert len(hists) == 1 and hists[0]["count"] == 1
    rejects = srv.flight.events("spec_reject")
    assert sum(e["rejected"] for e in rejects) == doc["rejected_total"]
    srv.close()
    eng = _spec_engine(model, _prompts(2), 2)
    eng.step()
    info = eng.spec_info()
    assert [s["slot"] for s in info] == [0, 1]
    assert all(s["rounds"] == 1 and s["drafted"] == DEPTH and s["on"] for s in info)
    assert "speculation" not in Server(model, ServeConfig(chunk=4, slots=2)).snapshot()


# -- the cause of C1: every product of the piece at DECODE_ROWS rows -------------------


def _piece_rows(model, slots):
    """The products' rows of a verify piece of ``slots`` x (depth + 1) fed
    tokens and of a draft step (``utils/row_probe.py``'s dispatch mode)."""
    _, states, t = _batch(model, slots)
    fed = torch.zeros(slots, DEPTH + 1, dtype=torch.long)
    lin = linear_layer_indices(CFG)
    return (product_rows(model.verify_step, fed, states, t),
            product_rows(model.draft_step, fed[:, 0], [states[i] for i in lin], t))


@pytest.mark.parametrize("slots", [4, 20])
def test_verify_and_draft_products_run_at_decode_rows(slots):
    """Every row-wise product of ``verify_step`` and ``draft_step`` sees
    ``DECODE_ROWS`` rows, as a decode step's, at 4 slots x 4 fed tokens (16
    rows, one block) and 20 x 4 (80 rows, two blocks: the head twice), for
    the full-precision, int8 and int4 layers and phi's learnable projection
    (on [DECODE_ROWS, H, Dh], as in decode)."""
    learnable = dataclasses.replace(CFG, feature_map="learnable", tie_embeddings=False)
    models = {"fp32": TransformerLM(CFG, device="cpu"),
              "learnable": TransformerLM(learnable, device="cpu")}
    models["int8"] = gen.quantize_for_decode(models["learnable"], "int8")
    models["int4"] = gen.quantize_for_decode(models["fp32"], "int4")
    blocks = -(-slots * (DEPTH + 1) // DECODE_ROWS)
    for name, m in models.items():
        verify, draft = _piece_rows(m, slots)
        assert {r for _, r, _ in verify + draft} == {DECODE_ROWS}, (name, verify, draft)
        heads = [r for op, r, dim in verify if op == "aten.matmul" and dim == 2]
        assert len(heads) >= blocks, (name, verify)
        if name == "learnable":  # phi's projection on [DECODE_ROWS, H, Dh]
            assert ("aten.linear", DECODE_ROWS, 3) in verify


def test_the_piece_at_its_own_row_count_differs(monkeypatch):
    """The control: with ``verify_rows`` undone the piece's products run at
    its own row count (16 rows), not a decode step's."""
    monkeypatch.setattr(transformer, "verify_rows", lambda n: n)
    verify, _ = _piece_rows(TransformerLM(CFG, device="cpu"), 4)
    assert {r for _, r, _ in verify} == {4 * (DEPTH + 1)}


# -- positions past max_seq_len ---------------------------------------------------------


def test_round_straddling_max_seq_len(model, jax_mp):
    """A request whose last rounds reach past ``max_seq_len`` (prompt 56 +
    8 new at 64, depth 3): the port clamps those positions (no index error
    on the softmax layer's cache or the tables) and serves the plain walk's
    tokens; the JAX package's speculating engine serves the same tokens
    (its lookup gives NaN past the end, where no emitted token reads). The
    verify piece at t = 62 runs and its in-range rows are bitwise the decode
    walk's."""
    p = np.random.default_rng(5).integers(0, CFG.vocab_size, (1, 56))
    eng = SlotEngine(model, slots=2, chunk=16, spec_depth=DEPTH, device="cpu")
    eng.admit(DecodeRequest(p, 8, GREEDY, seed=1), tag=0)
    done = _drain(eng)
    assert done[0].status == "ok" and int(eng._carry[2][0]) >= CFG.max_seq_len - 1
    ref = _solo(model, p, 8, GREEDY, 1)
    np.testing.assert_array_equal(done[0].tokens, ref)
    jeng = JaxSlotEngine(jax_mp.model, jax_mp.params, slots=2, chunk=16, spec_depth=DEPTH)
    jeng.admit(JaxDecodeRequest(prompt=jnp.asarray(p, jnp.int32), max_new_tokens=8,
                                sample=JaxSampleConfig(temperature=0.0), seed=1), tag=0)
    jdone = {}
    while jeng.busy:
        jdone.update(dict(jeng.step()))
    assert jdone[0].status == "ok"
    np.testing.assert_array_equal(np.asarray(jdone[0].tokens), ref)
    with torch.inference_mode():
        _, states = model.prefill_last(torch.from_numpy(p))
        t = torch.tensor([62])
        fed = torch.tensor([[1, 2, 3, 4]])
        logits, _ = model.verify_step(fed, snapshot_decode_state(states), t)
        st, ref_logits = snapshot_decode_state(states), []
        for j in range(2):
            lg, st = model.decode_step(fed[:, j], st, t + j)
            ref_logits.append(lg)
    assert torch.equal(logits[:, :2], torch.stack(ref_logits, 1))


# -- host reads and state -----------------------------------------------------------------


def test_one_host_read_per_speculative_boundary(model, monkeypatch):
    """A speculative boundary reads the device once: the probe's [3, slots]
    (``.cpu()`` once, no ``.item()`` / ``.tolist()``), and the round itself
    reads nothing."""
    calls = {"cpu": 0, "tolist": 0, "item": 0}

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, **kw):
            calls[name] += 1
            return orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, wrapped)

    eng = _spec_engine(model, [], 4)
    for i, p in enumerate(_prompts(4)):
        eng.admit(DecodeRequest(p, 40, GREEDY, seed=i), tag=i)
    for name in calls:
        counting(name)
    steps = 0
    while not any(s is not None and s.n_emitted + DEPTH + 1 >= s.target_new
                  for s in eng._slots):
        before = dict(calls)
        assert eng.step() == []
        steps += 1
        assert {k: calls[k] - before[k] for k in calls} == {"cpu": 1, "tolist": 0, "item": 0}
        assert eng._accept_np is not None and eng.last_boundary[0]["spec_round"]
    assert steps >= 2


def test_spec_round_carry_is_slots_times_the_slot_state(model):
    """In place of the JAX suite's jaxpr carry test: after a round the carry
    at 8 slots holds exactly 8 x the bytes of the carry at 1 slot (no state
    beyond the slots' O(1) rows), and the round's payloads scale alike."""
    def carry_bytes(slots):
        eng = SlotEngine(model, slots=slots, chunk=4, spec_depth=DEPTH, device="cpu")
        for i in range(slots):
            eng.admit(DecodeRequest(_prompts(slots)[i], 40, GREEDY, seed=i), tag=i)
        eng.step()
        token, states, t, emit, done = eng._carry
        leaves = [token, t, emit, done] + [x for st in states for x in st.values()]
        return sum(x.numel() * x.element_size() for x in leaves)

    assert carry_bytes(8) == 8 * carry_bytes(1)


def test_speculating_engine_never_runs_the_plain_chunk(model, monkeypatch):
    """In place of the JAX suite's compile count: while no slot is floored
    every pure-decode boundary is a round (``decode_batched_chunk`` never
    runs), and once every busy slot is floored the plain chunk owns them."""
    calls = {"plain": 0, "spec": 0}
    plain, spec = batching.decode_batched_chunk, batching.decode_batched_spec_round

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(batching, "decode_batched_chunk", count("plain", plain))
    monkeypatch.setattr(batching, "decode_batched_spec_round", count("spec", spec))
    prompts = _prompts(3)
    eng = _spec_engine(model, [], 2)
    done = _drain(eng, [(i, DecodeRequest(p, 12, GREEDY, seed=500 + i))
                        for i, p in enumerate(prompts)])
    assert all(r.status == "ok" for r in done.values())
    assert calls["plain"] == 0 and calls["spec"] > 0
    calls.update(plain=0, spec=0)
    eng = _spec_engine(model, prompts[:1], 1, spec_min_accept=1.01)
    _drain(eng)
    assert calls["spec"] == 2 and calls["plain"] > 0  # floored after two rounds


# -- the CLI -------------------------------------------------------------------------------


def test_cli_spec_depth_prints_the_speculation_line(tmp_path, capsys):
    """``--spec-depth 3`` serves, the tokens those of the plain run, with the
    stats line naming the depth and a ``speculation:`` line."""
    pf = tmp_path / "p.txt"
    pf.write_text("hello\nworld of tokens\n")
    args = ["--config", "tiny", "--device", "cpu", "--prompts-file", str(pf),
            "--max-new-tokens", "12", "--chunk", "4", "--slots", "2", "--temperature", "0",
            "--prefill-chunk", "0", "--prefill-buckets", "off"]
    assert cli_main(args) == 0
    plain = capsys.readouterr().out
    assert cli_main(args + ["--spec-depth", "3", "--spec-min-accept", "0"]) == 0
    out, err = capsys.readouterr()
    assert out == plain
    assert "spec-depth 3" in err and "speculation: " in err and "'ok': 2" in err
