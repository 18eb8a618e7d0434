"""The prefix cache under ``SlotEngine`` and ``Server`` and the quantized slot
modes, on the CPU, at the in-scan suite's tiny widths (one linear, one
softmax and one swa layer; linear chunk 4, so entries align on 4 tokens):

- against the JAX package's ``Server`` in one process, given the same
  weights, ``prefix_dir`` and ``session_dir``: a two-turn, shared-prefix plan
  gives equal greedy tokens and equal hit, miss, publish, save and resume
  counts;
- the reference's contracts from ``tests/test_quant_serving.py``, bitwise
  inside the port (each request against the port's one-row ``generate`` at
  its seed, on the quantized model where there is one): :122 batched == solo
  per qmode, greedy and sampled; :151 the in-scan prefill at int8; :212 the
  ladder's rewind at int8; :234 a session suspended and resumed at int8;
  :263 an unknown qmode; :285 / :343 a prefix hit == the cold request,
  greedy, sampled and per qmode; :407 a cross-qmode resume refused; :448
  the prefix cache needs in-scan prefill; :516 a corrupt entry falls back to
  a cold prefill; :625 the ladder's restart on a hit slot; :655 a hit admits
  at O(suffix);
- beside them: the publish's state is the exact-length ``prefill_last``'s,
  bitwise; a Server with a hit in its plan reads the device no more than the
  bare engine; the bounded publish queue drops and counts.

The reference's ``test_one_decode_compile_per_qmode`` and
``test_prefix_hit_zero_new_compiles`` count XLA compiles and have no
counterpart (eager torch compiles nothing).
"""

import numpy as np
import pytest
import torch

from orion_tpu.serving import DecodeRequest as JaxDecodeRequest
from orion_tpu.serving import ServeConfig as JaxServeConfig
from orion_tpu.serving import Server as JaxServer
from orion_tpu_torch import generate as gen
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.resilience.breaker import CircuitBreaker
from orion_tpu_torch.serving import (DecodeRequest, PrefixStore, ServeConfig, Server,
                                     SlotEngine, parse_buckets)
from test_torch_server import _Reads
from torch_serving_common import (CFG, GREEDY, SAMPLED, jax_model, jax_params, jax_sample, prompt,
                                  torch_model)

torch.set_num_threads(2)
PREFIX = 24


@pytest.fixture(scope="module")
def model():
    return torch_model()


@pytest.fixture(scope="module")
def qmodels(model):
    """The quantized models a Server(qmode=...) builds from ``model``."""
    return {mode: gen.quantize_for_decode(model, mode) for mode in ("int8", "int4")}


def _prompts(n, lens=(3, 5, 6, 4, 7)):
    return [prompt(1000 + i, lens[i % len(lens)]) for i in range(n)]


def _shared(suffix_seed, prefix_len=PREFIX, suffix_len=5):
    """A system-prompt-shaped prompt: one fixed prefix, a per-request suffix."""
    pre = np.random.default_rng(7).integers(0, CFG.vocab_size, (1, prefix_len))
    suf = np.random.default_rng(9000 + suffix_seed).integers(0, CFG.vocab_size, (1, suffix_len))
    return np.concatenate([pre, suf], axis=1)


def _ref(model, p, n_new, sample, seed):
    return gen.generate(model, torch.from_numpy(p), n_new, sample, seed).numpy()


def _prefix_server(model, tmp_path, qmode="off", **kw):
    return Server(model, ServeConfig(chunk=4, slots=2, max_inflight=8, prefill_chunk=8,
                                     prefix_dir=str(tmp_path / "prefix"), qmode=qmode,
                                     params_id="qserve-test:seed0", **kw))


def _published_store(model, tmp_path, **kw):
    """A store holding one committed generation of the shared prefix, from
    the exact-length ``prefill_last``."""
    store = PrefixStore(str(tmp_path / "store"), params_id="x", align=4, **kw)
    toks = _shared(1)[:, :PREFIX]
    with torch.inference_mode():
        _, states = model.prefill_last(torch.from_numpy(toks))
    assert store.publish(toks, states) == 1
    return store, toks


def _engine(model, store=None, slots=2):
    return SlotEngine(model, slots=slots, chunk=4,
                      prefill_buckets=parse_buckets("pow2", CFG.max_seq_len), prefill_chunk=8,
                      prefix_store=store, device="cpu")


def _drain(eng):
    done = {}
    while eng.busy:
        done.update(dict(eng.step()))
    return done


# -- against the JAX package's Server -------------------------------------------------------


def test_server_stores_match_the_jax_server(model, tmp_path):
    """Wave 1: a session's first turn and a request declaring the shared
    prefix (a miss, then its publish); wave 2: the session's continuation, a
    declared hit and an undeclared one. Tokens equal; the stores' counters
    equal."""
    def cfg(cls, d):
        return cls(chunk=4, slots=2, max_inflight=8, prefill_chunk=8, params_id="cmp",
                   prefix_dir=str(d / "prefix"), session_dir=str(d / "sessions"))

    jsrv = JaxServer(jax_model(), jax_params(), cfg(JaxServeConfig, tmp_path / "jax"))
    srv = Server(model, cfg(ServeConfig, tmp_path / "torch"))
    waves = [[(prompt(3000, 5), 8, "conv", 0), (_shared(1), 8, None, PREFIX)],
             [(np.zeros((1, 0), np.int64), 8, "conv", 0), (_shared(2), 8, None, PREFIX),
              (_shared(3), 8, None, 0)]]
    for w, wave in enumerate(waves):
        jps, ps = [], []
        for i, (p, n, sid, plen) in enumerate(wave):
            jps.append(jsrv.submit(JaxDecodeRequest(
                prompt=np.asarray(p, np.int32), max_new_tokens=n, sample=jax_sample(GREEDY),
                seed=10 * w + i, session_id=sid, prefix_len=plen)))
            ps.append(srv.submit(DecodeRequest(p, n, GREEDY, seed=10 * w + i, session_id=sid,
                                               prefix_len=plen)))
        assert jsrv.serve(drain_when_idle=True) == srv.serve(drain_when_idle=True) == 0
        for i, (jp, p) in enumerate(zip(jps, ps)):
            assert p.result.status == jp.result.status == "ok", (w, i, p.error, jp.error)
            np.testing.assert_array_equal(p.result.tokens, np.asarray(jp.result.tokens),
                                          err_msg=f"wave {w} request {i}")
    jflat, flat = jsrv.metrics.counters_flat(), srv.metrics.counters_flat()
    for key in ("prefix_hits", "prefix_misses", "prefix_publishes", "session_saves", "resumed"):
        assert flat.get(key, 0) == jflat.get(key, 0), key
    assert (flat["prefix_hits"], flat["prefix_misses"], flat["prefix_publishes"]) == (2, 2, 1)
    jsrv.close()
    srv.close()


# -- the quantized slot modes (test_quant_serving.py :122-263, :407) ------------------------


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_qmode_batched_parity_bitwise(model, qmodels, mode, sample):
    """6 requests through a 4-slot quantized Server (the queue refills freed
    slots at boundaries): each bitwise the quantized model's one-row
    generate; the Server's own quantization is the same as ours."""
    prompts = _prompts(6)
    refs = [_ref(qmodels[mode], p, 8, sample, 500 + i) for i, p in enumerate(prompts)]
    srv = Server(model, ServeConfig(chunk=4, slots=4, max_inflight=6, qmode=mode))
    ps = [srv.submit(DecodeRequest(p, 8, sample, seed=500 + i)) for i, p in enumerate(prompts)]
    assert srv.serve(drain_when_idle=True) == 0
    for i, (p, ref) in enumerate(zip(ps, refs)):
        assert p.result.status == "ok", (i, p.error)
        np.testing.assert_array_equal(p.result.tokens, ref, err_msg=f"{mode} {i}")
    srv.close()


def test_qmode_inscan_prefill_parity(model, qmodels):
    prompts = _prompts(3)
    refs = [_ref(qmodels["int8"], p, 8, GREEDY, 500 + i) for i, p in enumerate(prompts)]
    srv = Server(model, ServeConfig(chunk=4, slots=2, max_inflight=4, qmode="int8",
                                    prefill_chunk=8))
    ps = [srv.submit(DecodeRequest(p, 8, GREEDY, seed=500 + i)) for i, p in enumerate(prompts)]
    assert srv.serve(drain_when_idle=True) == 0
    for p, ref in zip(ps, refs):
        np.testing.assert_array_equal(p.result.tokens, ref)
    srv.close()


def test_qmode_ladder_rewind_bitwise(qmodels):
    p = _prompts(1)[0]
    ref = _ref(qmodels["int8"], p, 8, GREEDY, 11)
    eng = SlotEngine(qmodels["int8"], slots=2, chunk=4, device="cpu")
    eng.admit(DecodeRequest(p, 8, GREEDY, seed=11), tag="t")
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(0, 1, times=1)):
        res = _drain(eng)["t"]
    assert res.status == "ok" and (res.rewinds, res.reprefills) == (1, 0)
    np.testing.assert_array_equal(res.tokens, ref)


def test_qmode_session_suspend_resume_bitwise(model, qmodels, tmp_path):
    p = _prompts(1)[0]
    ref = _ref(qmodels["int8"], p, 16, GREEDY, 7)
    cfg = ServeConfig(chunk=4, slots=2, max_inflight=4, qmode="int8",
                      session_dir=str(tmp_path / "sess"))
    srv = Server(model, cfg)
    t1 = srv.submit(DecodeRequest(p, 8, GREEDY, seed=7, session_id="conv"))
    assert srv.serve(drain_when_idle=True) == 0 and t1.result.status == "ok"
    srv2 = Server(model, cfg)  # a restarted process quantizes alike
    t2 = srv2.submit(DecodeRequest(np.zeros((1, 0), np.int64), 8, GREEDY, session_id="conv"))
    assert srv2.serve(drain_when_idle=True) == 0 and t2.result.status == "ok", t2.error
    np.testing.assert_array_equal(np.concatenate([t1.result.tokens, t2.result.tokens], 1), ref)


def test_qmode_rejects_unknown_mode(model):
    with pytest.raises(ValueError, match="qmode"):
        Server(model, ServeConfig(qmode="fp8"))


def test_session_refuses_cross_qmode_resume(model, tmp_path):
    """A conversation suspended at int8 is refused by a full-precision
    Server (its identity error, for that request), and resumed by an int8
    one."""
    d = str(tmp_path / "sess")
    p = _prompts(1)[0]

    def serve(qmode, req):
        srv = Server(model, ServeConfig(chunk=4, slots=2, max_inflight=4, qmode=qmode,
                                        session_dir=d))
        pending = srv.submit(req)
        assert srv.serve(drain_when_idle=True) == 0
        return pending

    t1 = serve("int8", DecodeRequest(p, 8, GREEDY, seed=7, session_id="conv"))
    assert t1.result.status == "ok", t1.error
    cont = DecodeRequest(np.zeros((1, 0), np.int64), 8, GREEDY, session_id="conv")
    t2 = serve("off", cont)
    assert t2.result is None and "identity" in str(t2.error)
    t3 = serve("int8", cont)
    assert t3.result.status == "ok", t3.error


# -- the prefix cache (test_quant_serving.py :285-360, :448-677) ----------------------------


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_prefix_hit_bitwise_equals_uncached(model, tmp_path, sample):
    """A declares the 24-token prefix (a miss, then its publish); B shares
    it with another suffix and HITS: B bitwise its one-row generate."""
    srv = _prefix_server(model, tmp_path)
    ref_b = _ref(model, _shared(2), 8, sample, 501)
    a = srv.submit(DecodeRequest(_shared(1), 8, sample, seed=500, prefix_len=PREFIX))
    assert srv.serve(drain_when_idle=True) == 0 and a.result.status == "ok", a.error
    np.testing.assert_array_equal(a.result.tokens, _ref(model, _shared(1), 8, sample, 500))
    flat = srv.metrics.counters_flat()
    assert flat["prefix_misses"] == 1 and flat["prefix_publishes"] == 1
    b = srv.submit(DecodeRequest(_shared(2), 8, sample, seed=501, prefix_len=PREFIX))
    assert srv.serve(drain_when_idle=True) == 0 and b.result.status == "ok", b.error
    assert srv.metrics.counters_flat()["prefix_hits"] == 1
    np.testing.assert_array_equal(b.result.tokens, ref_b)
    hit = srv.flight.events("prefix_hit")[-1]
    assert (hit["prefix_len"], hit["suffix"]) == (PREFIX, 5)
    srv.close()


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_prefix_hit_bitwise_per_qmode(model, qmodels, tmp_path, mode):
    srv = _prefix_server(model, tmp_path, qmode=mode)
    ref_b = _ref(qmodels[mode], _shared(2), 8, GREEDY, 501)
    a = srv.submit(DecodeRequest(_shared(1), 8, GREEDY, seed=500, prefix_len=PREFIX))
    assert srv.serve(drain_when_idle=True) == 0 and a.result.status == "ok"
    b = srv.submit(DecodeRequest(_shared(2), 8, GREEDY, seed=501, prefix_len=PREFIX))
    assert srv.serve(drain_when_idle=True) == 0 and b.result.status == "ok"
    np.testing.assert_array_equal(b.result.tokens, ref_b)
    assert srv.metrics.counters_flat()["prefix_hits"] == 1
    # the entry is keyed by the qmode: a full-precision server misses it
    off = Server(model, ServeConfig(chunk=4, slots=2, prefill_chunk=8,
                                    prefix_dir=str(tmp_path / "prefix"),
                                    params_id="qserve-test:seed0"))
    c = off.submit(DecodeRequest(_shared(3), 8, GREEDY, seed=502))
    assert off.serve(drain_when_idle=True) == 0 and c.result.status == "ok"
    assert off.metrics.counters_flat()["prefix_hits"] == 0
    srv.close()
    off.close()


def test_publish_is_the_exact_length_prefill(model, tmp_path):
    """The published state is ``prefill_last`` of the prefix at its exact
    length (no bucket padding), bitwise; the publish reads the device only in
    ``publish_pending_prefixes``."""
    srv = _prefix_server(model, tmp_path)
    srv.submit(DecodeRequest(_shared(1), 8, GREEDY, prefix_len=PREFIX))
    assert srv.serve(drain_when_idle=True) == 0
    entry = srv.prefix_store.lookup(_shared(2))
    with torch.inference_mode():
        _, states = model.prefill_last(torch.from_numpy(_shared(1)[:, :PREFIX]))
    assert entry.t == PREFIX
    assert all(torch.equal(a[k], b[k]) for a, b in zip(entry.state, states) for k in a)
    srv.close()


def test_prefix_requires_inscan_prefill(model, tmp_path):
    with pytest.raises(ValueError, match="prefill_chunk"):
        Server(model, ServeConfig(prefix_dir=str(tmp_path / "p"), prefill_chunk=0))
    store = PrefixStore(str(tmp_path / "q"), params_id="x", align=8)
    with pytest.raises(ValueError, match="in-scan"):
        SlotEngine(model, slots=2, chunk=4, prefix_store=store, device="cpu")
    with pytest.raises(ValueError, match="alignment"):
        _engine(model, PrefixStore(str(tmp_path / "r"), params_id="x", align=6))


def test_corrupt_prefix_falls_back_to_cold_prefill(model, tmp_path):
    srv = _prefix_server(model, tmp_path)
    a = srv.submit(DecodeRequest(_shared(1), 8, GREEDY, seed=500, prefix_len=PREFIX))
    assert srv.serve(drain_when_idle=True) == 0 and a.result.status == "ok"
    key = srv.prefix_store.key_for(_shared(1)[:, :PREFIX])
    inject.corrupt_session(srv.prefix_store.directory, key)
    ref_b = _ref(model, _shared(2), 8, GREEDY, 501)
    with pytest.warns(UserWarning, match="corrupt"):
        b = srv.submit(DecodeRequest(_shared(2), 8, GREEDY, seed=501))
        assert srv.serve(drain_when_idle=True) == 0
    assert b.result.status == "ok", b.error
    np.testing.assert_array_equal(b.result.tokens, ref_b)
    flat = srv.metrics.counters_flat()
    assert flat["prefix_hits"] == 0 and flat["failed"] == 0
    srv.close()


def test_ladder_restart_on_prefix_hit_slot(model, tmp_path):
    """Rung 2 on a hit slot still consuming its suffix: the in-scan prefill
    RESTARTS from a zero row at position 0 (the cached row is not trusted
    again) and the tokens are bitwise the unfaulted run's."""
    store, _ = _published_store(model, tmp_path)
    eng = _engine(model, store)
    p = _shared(4, suffix_len=20)
    ref = _ref(model, p, 8, GREEDY, 42)
    eng.admit(DecodeRequest(p, 8, GREEDY, seed=42), tag="t")
    assert eng._slots[0].prompt_remaining == 20  # O(suffix), not O(prompt)
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(0, 0, times=2)):
        res = _drain(eng)["t"]
    assert res.status == "ok" and res.reprefills == 1
    np.testing.assert_array_equal(res.tokens, ref)


def test_prefix_hit_is_o_suffix_admission(model, tmp_path):
    """A 24 + 5 prompt admits with the 5-token suffix left (one piece); the
    cold one of 29 tokens has all 29 (four pieces of 8): the hit's slot
    emits from its first boundary, bitwise its one-row generate."""
    store, _ = _published_store(model, tmp_path)
    eng = _engine(model, store)
    hit_p, cold_p = _shared(5), prompt(4000, 29)
    eng.admit(DecodeRequest(hit_p, 4, GREEDY, seed=0), tag="hit")
    eng.admit(DecodeRequest(cold_p, 4, GREEDY, seed=1), tag="cold")
    assert [s.prompt_remaining for s in eng._slots] == [5, 29]
    pieces = []
    done = {}
    while eng.busy:
        done.update(dict(eng.step()))
        pieces.append([b["prefill_tokens"] for b in eng.last_boundary])
    assert pieces[0] == [5, 0], "the hit's whole suffix is one piece"
    assert sum(sum(b) for b in pieces) == 5 + 29
    np.testing.assert_array_equal(done["hit"].tokens, _ref(model, hit_p, 4, GREEDY, 0))
    np.testing.assert_array_equal(done["cold"].tokens, _ref(model, cold_p, 4, GREEDY, 1))


def test_server_adds_no_host_read_with_a_prefix_hit(model, tmp_path):
    """A Server whose plan hits the prefix store, against the bare engine
    with the same store and admissions: the same device reads and aten ops
    (the hit's row goes to the device as copies, no read)."""
    store, _ = _published_store(model, tmp_path)
    reqs = [DecodeRequest(_shared(10 + i), 8, GREEDY, seed=i) for i in range(3)]
    srv = Server(model, ServeConfig(chunk=4, slots=2, max_inflight=4, prefill_chunk=8,
                                    prefix_dir=store.directory, params_id="x",
                                    stall_timeout=60.0))
    for r in reqs:
        srv.submit(r)
    with _Reads() as served:
        srv.serve(drain_when_idle=True)
    assert srv.metrics.counters_flat()["prefix_hits"] == 3
    srv.close()
    eng = _engine(model, store)
    pending = list(reqs)
    with _Reads() as bare:
        while pending or eng.busy:
            while pending and eng.has_free_slot:
                eng.admit(pending.pop(0))
            eng.step()
    assert served.reads == bare.reads
    assert served.ops == bare.ops


def test_publish_queue_is_bounded(model, tmp_path):
    """With the store's breaker open, declared misses queue blind (no disk
    probe); past ``max_pending_prefixes`` a prefix is dropped and counted,
    and the requests are served cold, bitwise."""
    br = CircuitBreaker("prefix", consecutive_failures=1, backoff=60.0, jitter=0.0)
    store = PrefixStore(str(tmp_path / "p"), params_id="x", align=4, breaker=br)
    events = []
    eng = SlotEngine(model, slots=2, chunk=4, prefill_buckets=(8, 16, 32), prefill_chunk=8,
                     prefix_store=store, device="cpu",
                     on_event=lambda kind, f: events.append(kind))
    eng.max_pending_prefixes = 1
    br.record_failure("induced outage")
    prompts = [np.concatenate([prompt(5000 + i, PREFIX), prompt(6000 + i, 3)], 1)
               for i in range(2)]
    for i, p in enumerate(prompts):
        eng.admit(DecodeRequest(p, 4, GREEDY, seed=i, prefix_len=PREFIX), tag=i)
    assert eng.pending_prefix_count == 1 and eng.dropped_prefixes == 1
    assert events.count("prefix_miss") == 2 and events.count("prefix_drop") == 1
    assert eng.publish_pending_prefixes() == 0 and eng.has_pending_prefixes  # waits
    done = _drain(eng)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(done[i].tokens, _ref(model, p, 4, GREEDY, i))
