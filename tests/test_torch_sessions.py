"""Durable sessions through the port's ``Server`` (``serving/server.py`` over
``serving/session_store.py``) on the CPU, at the in-scan suite's tiny widths
(one linear, one softmax and one swa layer, so a session carries an (S, z),
a KV cache and a ring).

The reference's contracts from ``tests/test_sessions.py`` :240-754, bitwise
inside the port (every turn against the port's one-row ``generate`` at the
request's seed): two turns == one uninterrupted run, greedy and sampled; a
continuation served from the buffered overshoot; a restart resumes from
disk; a resume into another engine shape; the rebase of a turn with new
tokens; SIGTERM suspends the resident sessions and a restarted server
completes them; sessionless requests still drain; a corrupt session fails
only its request; the idle-eviction race; the LRU cap; one turn at a time;
sessions without a store; a mismatched continuation; the ladder on a resumed
slot; a failed turn releases its session; the dirty pin; the CLI round trip.
And from ``tests/test_storage_domains.py`` :365-615 the outage contracts: a
full store outage with zero failures and every turn bitwise, breakers
recovering without traffic, an open breaker making no syscall, the dirty
cap shedding retriably, and SIGTERM mid-outage exiting 0 with the dirty
sessions named. The reference's ``test_resume_reuses_existing_decode_compile``
counts XLA compiles and has no counterpart (eager torch compiles nothing).
"""

import time

import numpy as np
import pytest
import torch

from orion_tpu_torch import generate as gen
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.resilience.retry import RetryPolicy
from orion_tpu_torch.serving import (DecodeRequest, Health, OverloadError, ServeConfig, Server,
                                     SessionIntegrityError, SessionStore)
from orion_tpu_torch.serving.__main__ import main as cli_main
from torch_serving_common import CFG, GREEDY, SAMPLED, prompt, torch_model

torch.set_num_threads(2)
ONE_TRY = RetryPolicy(attempts=1)


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _prompt(i, ln=5):
    return prompt(2000 + i, ln)


def _cont():
    return np.zeros((1, 0), np.int64)


def _ref(model, p, n_new, sample, seed):
    return gen.generate(model, torch.from_numpy(p), n_new, sample, seed).numpy()


def _cfg(tmp_path, **kw):
    kw.setdefault("chunk", 4)
    kw.setdefault("slots", 2)
    kw.setdefault("max_inflight", 8)
    kw.setdefault("session_dir", str(tmp_path / "sessions"))
    return ServeConfig(**kw)


def _turn(srv, p, want, sample, seed, sid):
    pending = srv.submit(DecodeRequest(p, want, sample, seed=seed, session_id=sid))
    assert srv.serve(drain_when_idle=True) == 0
    return pending


def _cat(*pendings):
    return np.concatenate([p.result.tokens for p in pendings], axis=1)


# -- multi-turn continuation (test_sessions.py :240-356) ----------------------------------


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_two_turns_equal_one_uninterrupted_run(model, tmp_path, sample):
    """Turn 1 asks for 10 tokens (the carry overshoots to 12), turn 2 for 6
    more: 2 served from the buffer, 4 decoded; together bitwise the first 16
    tokens of one request at the seed."""
    p = _prompt(0)
    ref = _ref(model, p, 16, sample, 123)
    srv = Server(model, _cfg(tmp_path))
    p1 = _turn(srv, p, 10, sample, 123, "conv")
    assert p1.result.status == "ok" and p1.result.new_tokens == 10
    np.testing.assert_array_equal(p1.result.tokens, ref[:, :10])
    p2 = _turn(srv, _cont(), 6, sample, 999, "conv")
    assert p2.result.status == "ok" and p2.result.new_tokens == 6
    np.testing.assert_array_equal(_cat(p1, p2), ref)
    assert srv.stats["session_saves"] == 2 and srv.stats["resumed"] == 1
    srv.close()


def test_buffered_continuation_needs_no_device_work(model, tmp_path):
    p = _prompt(1)
    ref = _ref(model, p, 14, GREEDY, 5)
    srv = Server(model, _cfg(tmp_path))
    _turn(srv, p, 10, GREEDY, 5, "c2")  # the carry ran 12
    p2 = _turn(srv, _cont(), 2, GREEDY, 5, "c2")
    assert p2.result.status == "ok" and p2.result.chunks == 0
    np.testing.assert_array_equal(p2.result.tokens, ref[:, 10:12])
    p3 = _turn(srv, _cont(), 2, GREEDY, 5, "c2")  # the buffer's position was saved
    np.testing.assert_array_equal(p3.result.tokens, ref[:, 12:14])
    srv.close()


def test_restart_resumes_from_disk_bitwise(model, tmp_path):
    p = _prompt(2)
    ref = _ref(model, p, 16, GREEDY, 77)
    srv1 = Server(model, _cfg(tmp_path))
    p1 = _turn(srv1, p, 8, GREEDY, 77, "conv")
    srv1.close()
    srv2 = Server(model, _cfg(tmp_path))
    assert srv2.session_store.list_sessions() == ["conv"]
    plan = inject.FaultPlan().add("serve.session_load")
    with inject.inject(plan):
        p2 = _turn(srv2, _cont(), 8, GREEDY, 0, "conv")
    assert plan.delivered == ["serve.session_load@1"], "the restart reads the disk store"
    np.testing.assert_array_equal(_cat(p1, p2), ref)
    srv2.close()


def test_resume_into_different_engine_shape(model, tmp_path):
    p = _prompt(3)
    ref = _ref(model, p, 16, GREEDY, 42)
    srv1 = Server(model, _cfg(tmp_path, slots=2, chunk=4))
    p1 = _turn(srv1, p, 8, GREEDY, 42, "conv")
    srv1.close()
    srv2 = Server(model, _cfg(tmp_path, slots=3, chunk=2, prefill_chunk=0,
                              prefill_buckets="off"))
    p2 = _turn(srv2, _cont(), 8, GREEDY, 0, "conv")
    np.testing.assert_array_equal(_cat(p1, p2), ref)
    srv2.close()


def test_new_prompt_tokens_rebase_deterministically(model, tmp_path):
    """A turn with new tokens re-prefills the whole history: the same replay
    on two servers gives the same tokens, and the saved context grows by the
    emitted and the new tokens, the key fold continuing across."""

    def run(tmp):
        srv = Server(model, _cfg(tmp))
        p1 = _turn(srv, _prompt(4), 8, GREEDY, 9, "conv")
        p2 = _turn(srv, _prompt(5, ln=3), 8, GREEDY, 9, "conv")
        sess = srv.session_store.load("conv")
        srv.close()
        return p1.result.tokens, p2.result.tokens, sess

    t1a, t2a, sess = run(tmp_path / "a")
    t1b, t2b, _ = run(tmp_path / "b")
    np.testing.assert_array_equal(t1a, t1b)
    np.testing.assert_array_equal(t2a, t2b)
    assert t2a.shape == (1, 8)
    assert sess.prompt.shape == (1, 16) and sess.emitted.shape[1] == 8
    assert int(sess.emit) == 16
    # the rebased turn is the one-row walk over the whole context from fold 8
    full = np.concatenate([_prompt(4), t1a, _prompt(5, ln=3)], axis=1)
    keys = gen.request_keys(9, 1)
    c = gen.prefill_carry(model, torch.from_numpy(full), GREEDY, keys, sample_index=8)
    np.testing.assert_array_equal(t2a[:, :1], c[0][None].numpy())


# -- SIGTERM: suspend, restart, complete (test_sessions.py :358-462) ----------------------


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_sigterm_suspends_sessions_restart_completes_bitwise(model, tmp_path, sample):
    want = 24
    prompts = [_prompt(10), _prompt(11, ln=4)]
    refs = [_ref(model, p, want, sample, 500 + i) for i, p in enumerate(prompts)]
    srv1 = Server(model, _cfg(tmp_path))
    ps = [srv1.submit(DecodeRequest(p, want, sample, seed=500 + i, session_id=f"user{i}"))
          for i, p in enumerate(prompts)]
    with inject.inject(inject.FaultPlan().preempt_at_chunk(2)):
        rc = srv1.serve()
    assert rc == 0 and srv1.health.state is Health.DEAD
    for p in ps:
        assert p.result.status == "suspended" and 0 < p.result.new_tokens < want
    srv2 = Server(model, _cfg(tmp_path))
    assert srv2.session_store.list_sessions() == ["user0", "user1"]
    conts = [srv2.submit(DecodeRequest(_cont(), want - ps[i].result.new_tokens, sample,
                                       session_id=f"user{i}")) for i in range(2)]
    assert srv2.serve(drain_when_idle=True) == 0
    for i in range(2):
        assert conts[i].result.status == "ok"
        np.testing.assert_array_equal(_cat(ps[i], conts[i]), refs[i], err_msg=f"session {i}")
    srv2.close()


def test_sessionless_requests_still_drain_to_completion(model, tmp_path):
    prompts = [_prompt(20), _prompt(21)]
    ref_plain = _ref(model, prompts[0], 16, GREEDY, 0)
    srv = Server(model, _cfg(tmp_path))
    plain = srv.submit(DecodeRequest(prompts[0], 16, GREEDY, seed=0))
    tagged = srv.submit(DecodeRequest(prompts[1], 16, GREEDY, seed=1, session_id="sess"))
    with inject.inject(inject.FaultPlan().preempt_at_chunk(1)):
        assert srv.serve() == 0
    assert plain.result.status == "ok"
    np.testing.assert_array_equal(plain.result.tokens, ref_plain)
    assert tagged.result.status == "suspended" and tagged.result.new_tokens < 16


def test_corrupt_session_fails_only_that_request(model, tmp_path):
    p = _prompt(30)
    ref = _ref(model, p, 8, GREEDY, 3)
    srv1 = Server(model, _cfg(tmp_path, session_keep=1))
    _turn(srv1, p, 8, GREEDY, 3, "victim")
    srv1.close()
    inject.corrupt_session(str(tmp_path / "sessions"), "victim")
    srv2 = Server(model, _cfg(tmp_path, session_keep=1))
    bad = srv2.submit(DecodeRequest(_cont(), 8, GREEDY, session_id="victim"))
    good = srv2.submit(DecodeRequest(p, 8, GREEDY, seed=3))
    with pytest.warns(UserWarning):
        assert srv2.serve(drain_when_idle=True) == 0
    assert isinstance(bad.error, SessionIntegrityError)
    assert good.result.status == "ok"
    np.testing.assert_array_equal(good.result.tokens, ref)
    assert srv2.health.state is not Health.DEAD
    srv2.close()


# -- the session cache (test_sessions.py :465-569) ----------------------------------------


def test_idle_eviction_races_readmission_at_boundary(model, tmp_path):
    now = [0.0]
    p = _prompt(40)
    ref = _ref(model, p, 16, GREEDY, 8)
    srv = Server(model, _cfg(tmp_path, session_idle_s=10.0), clock=lambda: now[0])
    p1 = _turn(srv, p, 8, GREEDY, 8, "idler")
    assert "idler" in srv._sessions
    now[0] += 60.0
    p2 = srv.submit(DecodeRequest(_cont(), 8, GREEDY, session_id="idler"))
    plan = inject.FaultPlan().add("serve.session_load")
    with inject.inject(plan):
        assert srv.serve(drain_when_idle=True) == 0
    assert plan.delivered, "the idle-evicted session is read back from disk"
    np.testing.assert_array_equal(_cat(p1, p2), ref)
    srv.close()


def test_lru_cap_bounds_resident_cache(model, tmp_path):
    prompts = [_prompt(50), _prompt(51)]
    refs = [_ref(model, p, 16, GREEDY, 60 + i) for i, p in enumerate(prompts)]
    srv = Server(model, _cfg(tmp_path, max_resident_sessions=1))
    p1s = [_turn(srv, prompts[i], 8, GREEDY, 60 + i, f"lru{i}") for i in range(2)]
    assert len(srv._sessions) == 1 and len(srv.session_store.list_sessions()) == 2
    assert srv.snapshot()["sessions"] == {"resident": 1, "in_slots": 0, "dirty": 0,
                                          "resident_ids": ["lru1"]}
    for i in range(2):
        p2 = _turn(srv, _cont(), 8, GREEDY, 0, f"lru{i}")
        np.testing.assert_array_equal(_cat(p1s[i], p2), refs[i])
    srv.close()


def test_concurrent_turns_on_one_session_isolated_error(model, tmp_path):
    srv = Server(model, _cfg(tmp_path))
    a = srv.submit(DecodeRequest(_prompt(60), 16, GREEDY, session_id="dup"))
    b = srv.submit(DecodeRequest(_prompt(61), 4, GREEDY, seed=1, session_id="dup"))
    assert srv.serve(drain_when_idle=True) == 0
    assert a.result.status == "ok"
    assert isinstance(b.error, ValueError) and "one turn at a time" in str(b.error)
    srv.close()


def test_session_without_store_is_isolated_error(model):
    srv = Server(model, ServeConfig(chunk=4, slots=2))
    p = srv.submit(DecodeRequest(_prompt(62), 4, GREEDY, session_id="nope"))
    assert srv.serve(drain_when_idle=True) == 0
    assert isinstance(p.error, ValueError) and "session_dir" in str(p.error)
    srv.close()


def test_mismatched_continuation_sample_isolated_error(model, tmp_path):
    srv = Server(model, _cfg(tmp_path))
    _turn(srv, _prompt(63), 8, GREEDY, 0, "conv")
    p = srv.submit(DecodeRequest(_cont(), 8, SAMPLED, session_id="conv"))
    assert srv.serve(drain_when_idle=True) == 0
    assert isinstance(p.error, ValueError)
    srv.close()


# -- the ladder and failed turns (test_sessions.py :600-687) ------------------------------


def test_ladder_on_resumed_slot_recovers_bitwise(model, tmp_path):
    p = _prompt(80)
    ref = _ref(model, p, 16, GREEDY, 13)
    srv = Server(model, _cfg(tmp_path))
    p1 = _turn(srv, p, 8, GREEDY, 13, "conv")
    p2 = srv.submit(DecodeRequest(_cont(), 8, GREEDY, session_id="conv"))
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(0, chunk=1, times=2)):
        assert srv.serve(drain_when_idle=True) == 0
    assert p2.result.status == "ok" and (p2.result.rewinds, p2.result.reprefills) == (1, 1)
    np.testing.assert_array_equal(_cat(p1, p2), ref)
    srv.close()


def test_failed_turn_releases_session_and_last_generation_survives(model, tmp_path):
    p = _prompt(95)
    ref = _ref(model, p, 16, GREEDY, 31)
    srv = Server(model, _cfg(tmp_path))
    p1 = _turn(srv, p, 8, GREEDY, 31, "conv")
    p2 = srv.submit(DecodeRequest(_cont(), 8, GREEDY, session_id="conv"))
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(0, chunk=0, times=-1)):
        assert srv.serve(drain_when_idle=True) == 0
    assert p2.result.status == "failed" and p2.result.session is None
    assert "conv" not in srv._active_sessions, "a failed turn releases its session"
    p3 = _turn(srv, _cont(), 8, GREEDY, 0, "conv")
    assert p3.result.status == "ok"
    np.testing.assert_array_equal(_cat(p1, p3), ref)
    srv.close()


def test_dirty_session_pinned_until_save_lands(model, tmp_path):
    now = [0.0]
    p = _prompt(96)
    ref = _ref(model, p, 16, GREEDY, 17)
    srv = Server(model, _cfg(tmp_path, session_idle_s=10.0), clock=lambda: now[0])
    srv.session_store._retry = ONE_TRY
    plan = inject.FaultPlan().fail_io("serve.session_save", times=-1)
    with inject.inject(plan), pytest.warns(UserWarning, match="save failed"):
        p1 = _turn(srv, p, 8, GREEDY, 17, "frag")
    assert p1.result.status == "ok" and "frag" in srv._dirty_sessions
    assert srv.session_store.generations("frag") == []
    now[0] += 60.0  # past idle: a CLEAN entry would be evicted here
    assert srv.serve(drain_when_idle=True) == 0
    assert "frag" not in srv._dirty_sessions and srv.session_store.generations("frag") == [1]
    srv2 = Server(model, _cfg(tmp_path))
    p2 = _turn(srv2, _cont(), 8, GREEDY, 0, "frag")
    np.testing.assert_array_equal(_cat(p1, p2), ref)
    srv2.close()


def test_serving_cli_session_roundtrip(tmp_path, capsys):
    """--session-dir / --session-id over two invocations: turn 1 makes the
    session; the restarted process reports it restorable and an empty input
    resumes it (a second generation lands); --session-id alone is
    refused. Both turns are one uninterrupted greedy run's tokens."""
    store_dir = str(tmp_path / "store")
    pf = tmp_path / "prompts.txt"
    pf.write_text("ab\n")
    base = ["--config", "tiny", "--device", "cpu", "--max-new-tokens", "4", "--chunk", "2",
            "--temperature", "0", "--session-dir", store_dir, "--session-id", "conv"]
    assert cli_main(base + ["--prompts-file", str(pf)]) == 0
    out1 = capsys.readouterr().out
    store = SessionStore(store_dir)
    assert store.generations("conv") == [1] and store.load("conv").served == 4
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    assert cli_main(base + ["--prompts-file", str(empty)]) == 0
    out2 = capsys.readouterr()
    assert "1 suspended session(s) restorable" in out2.err
    assert store.generations("conv")[-1] == 2 and store.load("conv").served == 8
    from orion_tpu_torch.models.configs import TINY
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    m = gen.cast_params_for_inference(TransformerLM(TINY, device="cpu"))
    ids = gen.generate(m, torch.tensor([tok.encode("ab")]), 8, GREEDY, 0)[0].tolist()
    assert out1 == "ab" + tok.decode(ids[:4]) + "\n"
    assert out2.out == tok.decode(ids[4:]) + "\n"  # the continuation's line: no prompt
    assert cli_main(["--config", "tiny", "--device", "cpu", "--prompts-file", str(pf),
                     "--session-id", "x"]) == 2


# -- store outages (test_storage_domains.py :365-615) -------------------------------------


def _shared(suffix_seed, prefix_len=24, suffix_len=5):
    pre = np.random.default_rng(7).integers(0, CFG.vocab_size, (1, prefix_len))
    suf = np.random.default_rng(9000 + suffix_seed).integers(0, CFG.vocab_size, (1, suffix_len))
    return np.concatenate([pre, suf], axis=1)


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_store_outage_zero_failures_bitwise(model, tmp_path, sample):
    """Turn 1 healthy, turn 2 under a FULL outage of both stores (sessions
    eio, prefixes partition), turn 3 after it: every request ok; mid-outage
    DEGRADED "store-outage:*" with the failure domains in the snapshot; after
    it the dirty backlog lands, both breakers close, SERVING again, and the
    three turns of each session are bitwise one 24-token run."""
    cfg = _cfg(tmp_path, prefill_chunk=8, prefix_dir=str(tmp_path / "prefix"),
               params_id="storage-test:seed0", breaker_failures=1, breaker_backoff=0.02,
               breaker_max_backoff=0.05)
    srv = Server(model, cfg)
    srv.session_store._retry = ONE_TRY
    srv.prefix_store._retry = ONE_TRY
    prompts = [_prompt(0), _prompt(1, ln=4)]
    refs = [_ref(model, p, 24, sample, 700 + i) for i, p in enumerate(prompts)]
    pref_refs = {s: _ref(model, _shared(s), 8, sample, 800 + s) for s in (1, 2, 3)}

    def one_turn(turn, suffix_seed):
        ps = [srv.submit(DecodeRequest(prompts[i] if turn == 1 else _cont(), 8, sample,
                                       seed=700 + i, session_id=f"user{i}")) for i in range(2)]
        pp = srv.submit(DecodeRequest(_shared(suffix_seed), 8, sample, seed=800 + suffix_seed,
                                      prefix_len=24))
        assert srv.serve(drain_when_idle=True) == 0
        return ps, pp

    t1, a = one_turn(1, 1)
    for i, p in enumerate(t1):
        assert p.result.status == "ok", p.error
        np.testing.assert_array_equal(p.result.tokens, refs[i][:, :8])
    np.testing.assert_array_equal(a.result.tokens, pref_refs[1])
    assert srv.session_store.newest_generation("user0") >= 1
    plan = inject.FaultPlan()
    plan.degrade_site("serve.session_", kind="eio")
    plan.degrade_site("serve.prefix_", kind="partition")
    with inject.inject(plan):
        t2, b = one_turn(2, 2)
        for p in t2:
            assert p.result.status == "ok", p.error
        np.testing.assert_array_equal(b.result.tokens, pref_refs[2])
        assert srv._dirty_sessions == {"user0", "user1"}
        assert srv.health.state is Health.DEGRADED
        assert srv.health.reason.startswith("store-outage:")
        fd = srv.snapshot()["failure_domains"]
        assert fd["breakers"]["session"]["state"] in ("open", "half_open")
        assert fd["dirty_backlog"] == 2
    t3, c = one_turn(3, 3)
    for p in t3:
        assert p.result.status == "ok", p.error
    np.testing.assert_array_equal(c.result.tokens, pref_refs[3])
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and (
            srv._dirty_sessions or any(b.state != "closed" for b in srv._breakers.values())
            or srv.health.state is not Health.SERVING):
        time.sleep(0.03)
        assert srv.serve(drain_when_idle=True) == 0
    assert not srv._dirty_sessions
    assert {n: b.state for n, b in srv._breakers.items()} == {"session": "closed",
                                                              "prefix": "closed"}
    assert srv.health.state is Health.SERVING
    for i in range(2):
        np.testing.assert_array_equal(_cat(t1[i], t2[i], t3[i]), refs[i], err_msg=f"session {i}")
    flat = srv.metrics.counters_flat()
    assert flat.get("failed", 0) == 0 and flat.get("shed", 0) == 0
    assert srv.session_store.generations("user0")
    srv.close()


def test_breakers_recover_without_traffic(model, tmp_path):
    cfg = _cfg(tmp_path, prefix_dir=str(tmp_path / "prefix"), params_id="idle-probe",
               breaker_failures=1, breaker_backoff=0.02, breaker_max_backoff=0.05)
    srv = Server(model, cfg)
    srv.prefix_store.breaker.record_failure("induced outage")
    srv.session_store.breaker.record_failure("induced outage")
    assert srv.serve(drain_when_idle=True) == 0
    assert srv.health.state is Health.DEGRADED
    assert srv.health.reason.startswith("store-outage:")
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and any(
            b.state != "closed" for b in srv._breakers.values()):
        time.sleep(0.01)
        assert srv.serve(drain_when_idle=True) == 0
    assert all(b.state == "closed" for b in srv._breakers.values())
    assert srv.health.state is Health.SERVING
    assert [e["to"] for e in srv.flight.events("breaker")].count("closed") == 2
    srv.close()


def test_open_breaker_fail_fast_zero_store_syscalls(model, tmp_path):
    """The session breaker open and a 2 s-per-operation brownout armed under
    it: a resident session's turn completes without the stall; no store
    syscall reaches a hook."""
    srv = Server(model, _cfg(tmp_path, breaker_failures=1, breaker_backoff=30.0,
                             breaker_max_backoff=30.0))
    srv.session_store._retry = ONE_TRY
    p1 = _turn(srv, _prompt(40), 8, GREEDY, 40, "res")
    assert p1.result.status == "ok"
    srv.session_store.breaker.record_failure("induced outage")
    plan = inject.FaultPlan().degrade_site("serve.session_", kind="latency", latency=2.0)
    t0 = time.monotonic()
    with inject.inject(plan):
        p2 = _turn(srv, _cont(), 8, GREEDY, 0, "res")
    elapsed = time.monotonic() - t0
    assert p2.result.status == "ok", p2.error
    assert plan.delivered == [], "an open breaker: no syscall may reach a site"
    assert elapsed < 3.5, f"the turn took {elapsed:.2f} s under an open breaker"
    assert "res" in srv._dirty_sessions
    assert srv.health.state is Health.DEGRADED and srv.health.reason == "store-outage:session"
    srv.close()


def test_dirty_cap_sheds_new_sessions_retriable(model, tmp_path):
    srv = Server(model, _cfg(tmp_path, max_dirty_sessions=1, breaker_failures=1,
                             breaker_backoff=30.0, breaker_max_backoff=30.0))
    srv.session_store._retry = ONE_TRY
    assert _turn(srv, _prompt(50), 8, GREEDY, 50, "a").result.status == "ok"
    with inject.inject(inject.FaultPlan().degrade_site("serve.session_", kind="eio")):
        pa2 = _turn(srv, _cont(), 8, GREEDY, 0, "a")
    assert pa2.result.status == "ok", pa2.error
    assert srv._dirty_sessions == {"a"}
    pc = _turn(srv, _prompt(51), 8, GREEDY, 51, "c")
    assert pc.result is None and isinstance(pc.error, OverloadError)
    assert "retry" in str(pc.error)
    assert srv.flight.events("session_shed") and srv.stats["shed"] == 1
    pa3 = _turn(srv, _cont(), 8, GREEDY, 0, "a")
    assert pa3.result.status == "ok", pa3.error
    assert srv._dirty_sessions == {"a"}
    srv.close()


def test_sigterm_mid_outage_reports_dirty_and_exits_zero(model, tmp_path):
    srv = Server(model, _cfg(tmp_path, grace=0.5, poll=0.01, breaker_failures=1,
                             breaker_backoff=0.05, breaker_max_backoff=0.1))
    srv.session_store._retry = ONE_TRY
    assert _turn(srv, _prompt(60), 8, GREEDY, 60, "u").result.status == "ok"
    plan = inject.FaultPlan().degrade_site("serve.session_", kind="eio")
    plan.preempt_at_chunk(srv.engine._chunk_counter)
    p2 = srv.submit(DecodeRequest(_cont(), 8, GREEDY, session_id="u"))
    with pytest.warns(UserWarning, match="dirty session"), inject.inject(plan):
        rc = srv.serve()
    assert rc == 0 and srv.health.state is Health.DEAD
    assert p2.result.status == "suspended" and 0 < p2.result.new_tokens < 8
    events = srv.flight.events("drain_dirty")
    assert events and events[-1]["count"] == 1
    assert SessionStore(str(tmp_path / "sessions")).generations("u") == [1]
