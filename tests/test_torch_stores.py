"""The port's stores and their failure domains, below the Server, on the CPU:
``resilience/breaker.py``, the store sites, sustained regimes and damage
helpers of ``resilience/inject.py``, ``serving/session_store.py``'s
``SessionStore`` and ``serving/prefix_store.py``'s ``PrefixStore``.

- against the JAX package in one process: ``params_identity``,
  ``overrides_fingerprint`` and ``PrefixStore.key_for`` byte-equal for
  ``tiny``, ``lm_1b3`` and ``hybrid_1b3`` at off, int8 and int4;
  ``candidate_lengths`` and ``publish_length`` equal; the breaker walked in
  step with the JAX one on one fake clock;
- the reference's store contracts, inside the port, from
  ``tests/test_sessions.py`` :127-229 (round trips bitwise, bf16 leaves
  included; retention; a corrupt or truncated latest falls back; every
  generation corrupt raises; a kill mid-save; path traversal; typo'd sites),
  ``tests/test_storage_domains.py`` :138-365 (the breaker on a fake clock,
  the regimes, the scan sites, an open breaker making no syscall) and
  ``tests/test_quant_serving.py`` :363-407, :479-625 (keys by qmode and
  params, candidates, the declared hint, a kill mid-publish, corrupt
  fallbacks, retried I/O, racing publishes).
"""

import os
import shutil
import threading

import numpy as np
import pytest
import torch

from orion_tpu.models import configs as jax_configs
from orion_tpu.resilience.breaker import CircuitBreaker as JaxBreaker
from orion_tpu.serving import prefix_store as jax_prefix
from orion_tpu_torch.generate import SampleConfig
from orion_tpu_torch.models import configs
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.resilience.breaker import CircuitBreaker, StoreUnavailableError
from orion_tpu_torch.resilience.retry import RetryPolicy
from orion_tpu_torch.serving import (PrefixStore, SessionIdentityError, SessionIntegrityError,
                                     SessionState, SessionStore, overrides_fingerprint,
                                     params_identity)
from orion_tpu_torch.utils.config import parse_set_overrides

SAMPLED = SampleConfig(temperature=0.8, top_k=5, top_p=0.9, eos_token=3, pad_token=0)
ONE_TRY = RetryPolicy(attempts=1)


def _fake_session(sid="alice", seed=7, served=0, n_emitted=6, dtype=torch.float32):
    state = [
        {"s": (torch.arange(24, dtype=torch.float32).reshape(1, 2, 3, 4) / 7).to(dtype),
         "z": torch.ones(1, 2, 3, dtype=dtype)},
        {"k": torch.full((1, 2, 4, 3), 0.5, dtype=dtype), "v": torch.zeros(1, 2, 4, 3, dtype=dtype)},
    ]
    return SessionState(
        session_id=sid, seed=seed, sample=SAMPLED, served=served,
        token=np.array([9], np.int64), state=state, t=np.array(11, np.int64),
        emit=np.array(n_emitted, np.int64), done=np.array([False]),
        prompt=np.arange(5, dtype=np.int64)[None],
        emitted=np.arange(n_emitted, dtype=np.int64)[None])


def _assert_sessions_equal(a, b):
    for key in ("token", "t", "emit", "done", "prompt", "emitted"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and x.shape == y.shape, key
        np.testing.assert_array_equal(x, y, err_msg=key)
    for sa, sb in zip(a.state, b.state):
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    assert (a.seed, a.served, a.sample) == (b.seed, b.served, b.sample)


# -- against the JAX package --------------------------------------------------------------


@pytest.mark.parametrize("qmode", ["off", "int8", "int4"])
@pytest.mark.parametrize("name", ["tiny", "lm_1b3", "hybrid_1b3"])
def test_identities_and_keys_byte_equal_the_jax_package(tmp_path, name, qmode):
    """The stores' addresses are the JAX package's, byte for byte: a prefix
    directory is shareable and a params id means the same weights."""
    cfg, jcfg = configs.get_config(name), jax_configs.get_config(name)
    assert params_identity(cfg, qmode) == jax_prefix.params_identity(jcfg, qmode)
    assert params_identity(cfg, qmode, "step=7") == jax_prefix.params_identity(jcfg, qmode,
                                                                              "step=7")
    sets = ["d_model=128", "n_heads=4", "window=16"]
    assert overrides_fingerprint(parse_set_overrides(sets)) == jax_prefix.overrides_fingerprint(
        parse_set_overrides(sets))
    assert overrides_fingerprint({}) == jax_prefix.overrides_fingerprint({})
    pid = f"{name}:ov={overrides_fingerprint({})}:seed=0"
    store = PrefixStore(str(tmp_path / "t"), params_id=pid, qmode=qmode, align=64)
    jstore = jax_prefix.PrefixStore(str(tmp_path / "j"), params_id=pid, qmode=qmode, align=64)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 768))
    assert store.key_for(toks) == jstore.key_for(toks)  # int64 ids hash as int32, as JAX's
    assert store.key_for(toks[:, :64]) == jstore.key_for(toks[:, :64].astype(np.int32))


def test_candidates_and_publish_length_equal_the_jax_package(tmp_path):
    for align, probes in ((1, 64), (4, 64), (8, 4), (64, 64)):
        s = PrefixStore(str(tmp_path / "t"), params_id="a", align=align, max_probes=probes)
        j = jax_prefix.PrefixStore(str(tmp_path / "j"), params_id="a", align=align,
                                   max_probes=probes)
        for n in (0, 1, 7, 8, 9, 24, 25, 29, 1001):
            for declared in (0, 3, 8, 24, 512, 2000):
                assert s.candidate_lengths(n, declared) == j.candidate_lengths(n, declared)
                assert s.publish_length(n, declared) == j.publish_length(n, declared)


def test_breaker_walks_in_step_with_the_jax_breaker():
    """One fake clock, the same sequence of samples: the same states and
    snapshots (the jitter is seeded from the name in both)."""
    t = [0.0]
    a = CircuitBreaker("session", consecutive_failures=2, backoff=0.3, clock=lambda: t[0])
    b = JaxBreaker("session", consecutive_failures=2, backoff=0.3, clock=lambda: t[0])
    steps = ["f", "s", "f", "f", 0.2, "allow", 0.5, "allow", "f", 1.5, "allow", "s", "f", "f",
             "f", 3.0, "allow", "s"]
    for op in steps:
        if isinstance(op, float):
            t[0] = op
        elif op == "allow":
            assert a.allow() == b.allow()
        elif op == "f":
            a.record_failure("x")
            b.record_failure("x")
        else:
            a.record_success()
            b.record_success()
        assert a.snapshot() == b.snapshot() and a.blocked() == b.blocked()


# -- the session store (test_sessions.py :127-229) ----------------------------------------


def test_store_roundtrip_bitwise(tmp_path):
    store = SessionStore(str(tmp_path))
    sess = _fake_session()
    assert store.save(sess) == 1
    back = store.load("alice")
    assert back.generation == 1
    _assert_sessions_equal(sess, back)
    assert store.load("nobody") is None
    assert store.list_sessions() == ["alice"]


def test_store_roundtrip_bfloat16_leaves(tmp_path):
    """bf16 leaves (a bf16 model's caches and rings) round-trip bitwise
    through their 16-bit words, recorded as "bfloat16" in the manifest."""
    store = SessionStore(str(tmp_path))
    sess = _fake_session()
    sess.state[1]["k"] = torch.linspace(-3, 7, 24).reshape(1, 2, 4, 3).to(torch.bfloat16)
    sess.state[1]["v"] = torch.tensor([float("inf"), -0.0, 1e-40, 3.0]).repeat(6).reshape(
        1, 2, 4, 3).to(torch.bfloat16)
    store.save(sess)
    back = store.load("alice")
    _assert_sessions_equal(sess, back)
    assert back.state[1]["k"].dtype == torch.bfloat16
    import json

    doc = json.load(open(os.path.join(str(tmp_path), "alice", "gen-000001.json")))
    assert {e["dtype"] for e in doc["manifest"]["leaves"]} >= {"bfloat16", "float32", "int64",
                                                              "bool"}


def test_store_retention_keeps_last_n(tmp_path):
    store = SessionStore(str(tmp_path), keep=2)
    sess = _fake_session()
    for served in (1, 2, 3, 4):
        sess.served = served
        store.save(sess)
    assert store.generations("alice") == [3, 4]
    assert store.load("alice").served == 4


@pytest.mark.parametrize("damage,match", [(inject.corrupt_session, "corrupt or incomplete"),
                                          (inject.truncate_session, "falling back")])
def test_damaged_latest_falls_back_with_warning(tmp_path, damage, match):
    store = SessionStore(str(tmp_path), keep=2)
    sess = _fake_session(served=0)
    store.save(sess)
    sess.served = 3
    store.save(sess)
    damage(str(tmp_path), "alice")  # the newest generation's payload
    with pytest.warns(UserWarning, match=match):
        back = store.load("alice")
    assert back.generation == 1 and back.served == 0


def test_all_generations_corrupt_raises_integrity_error(tmp_path):
    store = SessionStore(str(tmp_path), keep=1)
    store.save(_fake_session())
    inject.corrupt_session(str(tmp_path), "alice")
    with pytest.warns(UserWarning), pytest.raises(SessionIntegrityError):
        store.load("alice")


def test_kill_mid_save_leaves_previous_generation(tmp_path):
    """A save that dies before its manifest rename is invisible: the injected
    I/O fault inside the retried region, and a torn .bin with no .json."""
    store = SessionStore(str(tmp_path), retry=ONE_TRY)
    sess = _fake_session(served=1)
    store.save(sess)
    sess.served = 2
    plan = inject.FaultPlan().fail_io("serve.session_save")
    with inject.inject(plan), pytest.raises(OSError):
        store.save(sess)
    assert plan.delivered == ["serve.session_save@2"]
    assert store.generations("alice") == [1] and store.load("alice").served == 1
    with open(os.path.join(str(tmp_path), "alice", "gen-000002.bin"), "wb") as f:
        f.write(b"half a session")
    assert store.generations("alice") == [1] and store.load("alice").served == 1


def test_store_rejects_path_traversal_ids(tmp_path):
    store = SessionStore(str(tmp_path))
    for bad in ("../evil", "a/b", ".hidden", ""):
        with pytest.raises(ValueError):
            store.load(bad)


def test_unknown_fault_site_rejected():
    with pytest.raises(ValueError, match="unknown fault-injection site"):
        inject.FaultPlan().fail_io("serve.sesion_save")


def test_identity_mismatch_is_not_a_fallback(tmp_path):
    SessionStore(str(tmp_path), identity="p|int4").save(_fake_session())
    with pytest.raises(SessionIdentityError, match="identity"):
        SessionStore(str(tmp_path), identity="p|off").load("alice")
    assert SessionStore(str(tmp_path), identity="p|int4").load("alice").generation == 1


# -- the breaker on a fake clock (test_storage_domains.py :138-216) -----------------------


def test_breaker_trip_probe_recover_fake_clock():
    t = [0.0]
    seen = []
    br = CircuitBreaker("session", consecutive_failures=2, backoff=1.0, jitter=0.0,
                        clock=lambda: t[0],
                        observer=lambda name, old, new, why: seen.append((old, new)))
    assert br.state == "closed" and br.allow() and not br.blocked()
    br.record_failure("scan: OSError")
    assert br.state == "closed"
    br.record_failure("scan: OSError")
    assert br.state == "open" and br.is_open and br.blocked() and not br.allow()
    snap = br.snapshot()
    assert snap["state"] == "open" and snap["probe_in_secs"] == pytest.approx(1.0)
    assert snap["reason"]
    t[0] = 0.5
    assert br.blocked() and not br.allow()
    t[0] = 1.01
    assert not br.blocked() and br.allow() and br.state == "half_open"
    assert not br.allow()  # one probe at a time
    br.record_success()
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    t[0] = 2.2
    assert br.allow()
    br.record_failure("probe failed")
    assert br.state == "open" and br.snapshot()["probe_in_secs"] == pytest.approx(2.0)
    assert {("closed", "open"), ("open", "half_open"), ("half_open", "closed"),
            ("half_open", "open")} <= set(seen)


def test_breaker_windowed_failure_rate_trips():
    t = [0.0]
    br = CircuitBreaker("prefix", consecutive_failures=100, window=8, min_samples=8,
                        failure_rate=0.5, backoff=1.0, jitter=0.0, clock=lambda: t[0])
    for _ in range(3):
        br.record_failure()
        br.record_success()
    br.record_failure()
    assert br.state == "closed"  # 7 samples: under min_samples
    br.record_failure()
    assert br.state == "open" and "operations failed" in br.snapshot()["reason"]


def test_breaker_open_straggler_success_is_ignored():
    br = CircuitBreaker("session", consecutive_failures=1, backoff=1.0, jitter=0.0,
                        clock=lambda: 0.0)
    br.record_failure()
    br.record_success()  # an operation that started before the trip
    assert br.state == "open" and br.blocked()


# -- sustained regimes (test_storage_domains.py :219-290) ---------------------------------


@pytest.mark.parametrize("kind", ["eio", "enospc", "latency", "partition"])
def test_regime_window_semantics(kind):
    sleeps = []
    plan = inject.FaultPlan()
    plan.sleep = sleeps.append
    plan.degrade_site("serve.session_save", kind=kind, from_step=2, until_step=4, latency=0.123)
    with inject.inject(plan):
        inject.fire("serve.session_save", step=0)  # the clock reads 0 < 2
        assert plan.delivered == []
        inject.fire("serve.chunk_delay", step=2)
        if kind == "latency":
            inject.fire("serve.session_save", step=0)
            assert sleeps == [0.123]
        else:
            with pytest.raises(OSError) as ei:
                inject.fire("serve.session_save", step=0)
            assert ei.value.errno == inject._REGIME_ERRNO[kind] and kind in str(ei.value)
        assert len(plan.delivered) == 1
        inject.fire("serve.chunk_delay", step=4)
        inject.fire("serve.session_save", step=0)
        assert len(plan.delivered) == 1


def test_regime_one_shot_takes_precedence():
    plan = inject.FaultPlan().degrade_site("serve.session_save", kind="eio")
    plan.fail_io("serve.session_save", exc=ValueError, msg="one-shot wins")
    with inject.inject(plan):
        with pytest.raises(ValueError, match="one-shot wins"):
            inject.fire("serve.session_save")
        with pytest.raises(OSError):
            inject.fire("serve.session_save")


def test_regime_validation_rejects_misarmed_plans():
    plan = inject.FaultPlan()
    with pytest.raises(ValueError, match="unknown regime kind"):
        plan.degrade_site("serve.session_", kind="flood")
    with pytest.raises(ValueError, match="covers no registered"):
        plan.degrade_site("serve.sesion_")
    with pytest.raises(ValueError, match="empty regime window"):
        plan.degrade_site("serve.session_", from_step=3, until_step=3)
    with pytest.raises(ValueError, match="unknown regime clock site"):
        plan.degrade_site("serve.session_", clock_site="nope")


def test_store_scan_sites_fire(tmp_path):
    store = SessionStore(str(tmp_path / "s"))
    plan = inject.FaultPlan().add("serve.session_scan", times=1)
    with inject.inject(plan):
        store.generations("nobody")
    assert plan.delivered == ["serve.session_scan@None"]
    pstore = PrefixStore(str(tmp_path / "p"), params_id="t", align=4)
    plan2 = inject.FaultPlan().add("serve.prefix_scan", times=1)
    with inject.inject(plan2):
        pstore.generations("deadbeef")
    assert plan2.delivered == ["serve.prefix_scan@None"]


# -- store units under a breaker (test_storage_domains.py :293-362) -----------------------


def test_session_store_outage_opens_breaker_then_probes(tmp_path):
    """Two failed saves open the breaker; while it is open save, load and
    generations refuse with the plan's delivery log FROZEN (no operation
    reached a hook: no syscall); after the dwell the first save is the probe
    and closes the breaker."""
    t = [0.0]
    br = CircuitBreaker("session", consecutive_failures=2, backoff=1.0, jitter=0.0,
                        clock=lambda: t[0])
    store = SessionStore(str(tmp_path), retry=ONE_TRY, breaker=br)
    sess = _fake_session()
    assert store.save(sess) == 1
    plan = inject.FaultPlan().degrade_site("serve.session_", kind="eio")
    with inject.inject(plan):
        for _ in range(2):
            with pytest.raises(OSError):
                store.save(sess)
        assert br.state == "open"
        frozen = len(plan.delivered)
        for _ in range(5):
            for op in (lambda: store.save(sess), lambda: store.load("alice"),
                       lambda: store.generations("alice")):
                with pytest.raises(StoreUnavailableError):
                    op()
        assert len(plan.delivered) == frozen, "an open breaker must not touch the disk"
    t[0] = 1.5
    gen = store.save(sess)
    assert br.state == "closed" and store.generations("alice")[-1] == gen


def test_prefix_store_open_breaker_is_instant_miss(tmp_path):
    t = [0.0]
    br = CircuitBreaker("prefix", consecutive_failures=1, backoff=1.0, jitter=0.0,
                        clock=lambda: t[0])
    store = PrefixStore(str(tmp_path), params_id="t", align=4, retry=ONE_TRY, breaker=br)
    prefix = np.arange(8)[None]
    state = {"k": torch.linspace(0, 1, 12).reshape(3, 4)}
    assert store.publish(prefix, state) == 1
    prompt = np.concatenate([prefix, [[1, 2, 3]]], axis=1)
    assert store.lookup(prompt, declared=8).t == 8
    plan = inject.FaultPlan().degrade_site("serve.prefix_", kind="partition")
    with inject.inject(plan):
        assert store.lookup(prompt, declared=8) is None
        assert br.state == "open"
        frozen = len(plan.delivered)
        for _ in range(5):
            assert store.lookup(prompt, declared=8) is None
        with pytest.raises(StoreUnavailableError):
            store.publish(prefix, state, skip_if_present=False)
        assert len(plan.delivered) == frozen, "an open breaker must not probe the disk"
    t[0] = 1.5
    hit = store.lookup(prompt, declared=8)  # the half-open probe
    assert hit is not None and hit.t == 8 and br.state == "closed"
    assert torch.equal(hit.state["k"], state["k"])


# -- the prefix store (test_quant_serving.py :363-407, :479-625) --------------------------


def _published(tmp_path, align=4, dtype=torch.float32):
    store = PrefixStore(str(tmp_path), params_id="x", align=align)
    toks = np.random.default_rng(7).integers(0, 64, (1, 24))
    g = torch.Generator().manual_seed(0)
    state = [{"s": torch.randn(1, 2, 16, 16, generator=g), "z": torch.randn(1, 2, 16, generator=g)},
             {"k": torch.randn(1, 2, 96, 16, generator=g).to(dtype),
              "v": torch.randn(1, 2, 96, 16, generator=g).to(dtype)}]
    assert store.publish(toks, state) == 1
    return store, toks, state


def _probe(toks):
    return np.concatenate([toks, np.zeros((1, 4), np.int64)], axis=1)


def _states_equal(a, b):
    return all(torch.equal(x[k], y[k]) and x[k].dtype == y[k].dtype for x, y in zip(a, b)
               for k in x)


def test_prefix_entries_keyed_by_qmode_and_params(tmp_path):
    toks = np.arange(16).reshape(1, -1)
    s1, s2, s3, s4 = (PrefixStore(str(tmp_path), params_id=p, qmode=q, align=8)
                      for p, q in (("a", "off"), ("a", "int8"), ("b", "off"), ("a", "off")))
    assert len({s.key_for(toks) for s in (s1, s2, s3)}) == 3
    assert s1.key_for(toks) == s4.key_for(toks)
    assert params_identity(configs.TINY, "int8") != params_identity(configs.TINY, "off")


def test_prefix_candidates_and_publish_length(tmp_path):
    store = PrefixStore(str(tmp_path), params_id="a", align=8)
    assert store.candidate_lengths(25) == [24, 16, 8]
    assert store.candidate_lengths(24) == [16, 8]  # 24 would leave no suffix token
    assert store.candidate_lengths(8) == []
    assert store.publish_length(29, declared=24) == 24
    assert store.publish_length(24, declared=24) == 16
    assert store.publish_length(29, declared=7) == 0
    with pytest.raises(ValueError, match="align"):
        PrefixStore(str(tmp_path), params_id="a", align=0)
    with pytest.raises(ValueError, match="alignment"):
        store.publish(np.arange(12)[None], {"k": torch.zeros(1)})


def test_prefix_declared_hint_beats_the_probe_budget(tmp_path):
    store = PrefixStore(str(tmp_path), params_id="a", align=8, max_probes=4)
    cands = store.candidate_lengths(1001, declared=512)
    assert cands[0] == 512 and len(cands) <= 4
    assert store.candidate_lengths(25, declared=24) == [24, 16, 8]


def test_prefix_roundtrip_bfloat16_state(tmp_path):
    store, toks, state = _published(tmp_path, dtype=torch.bfloat16)
    entry = store.lookup(_probe(toks))
    assert entry.t == 24 and entry.tokens.dtype == np.int32
    np.testing.assert_array_equal(entry.tokens, toks)
    assert _states_equal(entry.state, state)


def test_kill_mid_publish_leaves_previous_generation_intact(tmp_path):
    store, toks, state = _published(tmp_path)
    key = store.key_for(toks)
    ref = store.lookup(_probe(toks))
    assert ref.generation == 1
    plan = inject.FaultPlan().fail_io("serve.prefix_save", times=-1)
    store._retry = RetryPolicy(attempts=2, base_delay=0.001, max_delay=0.002)
    with inject.inject(plan), pytest.raises(OSError):
        store.publish(toks, ref.state, skip_if_present=False)
    assert plan.delivered == ["serve.prefix_save@2"] * 2
    assert store.generations(key) == [1]
    d = store._dir(key)
    shutil.copyfile(store._bin(d, 1), store._bin(d, 2))  # a torn publish: no manifest
    assert store.generations(key) == [1]
    again = store.lookup(_probe(toks))
    assert again.generation == 1 and _states_equal(again.state, ref.state)


def test_corrupt_latest_prefix_falls_back_to_previous_generation(tmp_path):
    store, toks, state = _published(tmp_path)
    key = store.key_for(toks)
    store.publish(toks, state, skip_if_present=False)
    assert store.generations(key) == [1, 2]
    inject.corrupt_session(store.directory, key, generation=2)
    with pytest.warns(UserWarning, match="corrupt"):
        entry = store.lookup(_probe(toks))
    assert entry.generation == 1 and _states_equal(entry.state, state)
    inject.truncate_session(store.directory, key, generation=1)
    with pytest.warns(UserWarning, match="corrupt"):
        assert store.lookup(_probe(toks)) is None  # every generation damaged: a miss


def test_prefix_io_retried_through_fault_sites(tmp_path):
    store, toks, _ = _published(tmp_path)
    store._retry = RetryPolicy(attempts=3, base_delay=0.001, max_delay=0.002)
    plan = inject.FaultPlan().fail_io("serve.prefix_load", times=1).fail_io(
        "serve.prefix_save", times=1)
    with inject.inject(plan), pytest.warns(UserWarning, match="retrying"):
        entry = store.lookup(_probe(toks))
        assert entry.generation == 1
        assert store.publish(toks, entry.state, skip_if_present=False) == 2
    assert plan.delivered == ["serve.prefix_load@1", "serve.prefix_save@2"]


def test_racing_publishes_converge(tmp_path):
    _, toks, state = _published(tmp_path / "seed")
    d = str(tmp_path / "race")
    replicas = [PrefixStore(d, params_id="x", align=4) for _ in range(2)]
    barrier = threading.Barrier(2)
    errors = []

    def racer(s):
        try:
            barrier.wait(timeout=10)
            s.publish(toks, state, skip_if_present=False)
        except Exception as e:  # surfaced through errors
            errors.append(e)

    threads = [threading.Thread(target=racer, args=(s,)) for s in replicas]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    got = replicas[0].lookup(_probe(toks))
    np.testing.assert_array_equal(got.tokens, toks)
    assert _states_equal(got.state, state)
    key = replicas[0].key_for(toks)
    assert not [n for n in os.listdir(replicas[0]._dir(key)) if ".tmp-" in n]


def test_foreign_entry_is_ignored(tmp_path):
    """An entry published for other weights under the same directory is
    never served: its key differs, and a planted copy fails the params
    check (a miss with a warning, never a wrong state)."""
    store, toks, _ = _published(tmp_path)
    other = PrefixStore(str(tmp_path), params_id="y", align=4)
    assert other.lookup(_probe(toks)) is None
    shutil.copytree(store._dir(store.key_for(toks)), other._dir(other.key_for(toks)))
    with pytest.warns(UserWarning, match="corrupt"):
        assert other.lookup(_probe(toks)) is None
