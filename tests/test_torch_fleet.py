"""The port's fleet (``orion_tpu_torch/fleet/``) on the CPU, every replica
asked for the CPU explicitly:

- against the JAX package: its ``--local`` fleet CLI at ``tiny`` and the
  port's, on the JAX package's seeded weights converted, print the same
  greedy lines, bitwise;
- the reference's fleet contracts (``tests/test_fleet.py`` :156-797)
  bitwise inside the port, each request held against the port's one-row
  ``generate`` at its seed: least-loaded dispatch, routing around degraded /
  draining / dead replicas, shedding at the fleet bound, ``fleet.dispatch``
  failover, the fleet-wide session fence, spawn retries, the autoscaler's
  hysteresis / scale-in / burn pressure, the atomic snapshot,
  cross-replica resume, the stale resident cache, a drain mid-stream
  rerouted (greedy and sampled), a replica killed mid-turn, the supervisor's
  drain-and-respawn of a degraded replica and its respawn held back through
  a store outage, fleet overload, the CLI (``--local`` and with a drain
  continued through the router) (the child-process transport:
  ``tests/test_torch_fleet_process.py``); ``--tp`` and ``--exec-dir`` are
  refused by name.

Tolerance: tokens bitwise (greedy on fp32 weights on both sides).
"""

import os
import threading
from collections.abc import Mapping

import numpy as np
import pytest
import torch

from orion_tpu_torch import generate as gen
from orion_tpu_torch.fleet import (AutoscalePolicy, LocalReplica, ReplicaHandle, Router,
                                   Supervisor)
from orion_tpu_torch.fleet import __main__ as fleet_cli
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.resilience.retry import RetryPolicy
from orion_tpu_torch.serving import (DecodeRequest, Health, OverloadError, RejectedError,
                                     ServeConfig, Server)
from torch_serving_common import CFG, GREEDY, SAMPLED, torch_model

torch.set_num_threads(2)
FAST_RETRY = RetryPolicy(attempts=3, base_delay=0.0, max_delay=0.0)


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _prompt(i, ln=5):
    return np.random.default_rng(2000 + i).integers(0, CFG.vocab_size, (1, ln))


def _ref(model, prompt, n_new, sample, seed):
    return gen.generate(model, torch.from_numpy(prompt), n_new, sample, seed).numpy()


def _serve_cfg(tmp_path, **kw):
    kw.setdefault("chunk", 4)
    kw.setdefault("slots", 2)
    kw.setdefault("max_inflight", 8)
    kw.setdefault("session_dir", str(tmp_path / "sessions"))
    return ServeConfig(**kw)


def _local_fleet(model, tmp_path, n=2, sup_kw=None, **cfg_kw):
    """A Supervisor over n thread-backed replicas sharing one session dir."""
    cfg = _serve_cfg(tmp_path, **cfg_kw)

    def factory(name):
        return LocalReplica(model, cfg, name=name).start()

    return Supervisor(factory, n, **(sup_kw or {})).start()


def _req(prompt, want, sample, seed, sid=None):
    return DecodeRequest(prompt=prompt, max_new_tokens=want, sample=sample, seed=seed,
                         session_id=sid)


def _cont(want, sample, sid):
    return _req(np.zeros((1, 0), np.int64), want, sample, 0, sid)


def _wait(pending, timeout=120.0):
    assert pending.done.wait(timeout=timeout), "request never resolved"
    return pending


# -- against the JAX package -------------------------------------------------------------


def test_local_fleet_cli_matches_the_jax_fleet(tmp_path, capsys, monkeypatch):
    """``python -m orion_tpu.fleet --local --config tiny`` and the port's
    CLI over the same weights (the JAX package's seeded init, converted):
    the same stdout, bitwise, greedy."""
    from orion_tpu.fleet.__main__ import main as jax_main
    from orion_tpu.fleet.replica import ReplicaSpec as JaxSpec
    from orion_tpu.fleet.replica import build_model as jax_build
    from orion_tpu_torch.convert import load_jax_params
    from orion_tpu_torch.models.configs import TINY
    from orion_tpu_torch.models.transformer import TransformerLM

    _, params, pid = jax_build(JaxSpec(config="tiny"))
    converted = load_jax_params(TransformerLM(TINY, device="cpu"),
                                {"params": np_tree(params["params"])})
    monkeypatch.setattr(fleet_cli, "build_model", lambda spec: (converted, pid))
    pf = tmp_path / "prompts.txt"
    pf.write_text("hello\nthe fleet\nabc\n")
    args = ["--local", "--replicas", "2", "--config", "tiny", "--prompts-file", str(pf),
            "--max-new-tokens", "8", "--chunk", "4", "--slots", "2", "--temperature", "0"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    assert fleet_cli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert len(got.splitlines()) == 3 and got == want


def np_tree(tree):
    return {k: np_tree(v) if isinstance(v, Mapping) else np.asarray(v) for k, v in tree.items()}


# -- router unit tests over scripted fakes ----------------------------------------------------


class FakePending:
    def __init__(self):
        self.done = threading.Event()


class FakeReplica(ReplicaHandle):
    """Scripted replica: fixed health / load, records what it was handed."""

    def __init__(self, name, state="serving", inflight=0, alive=True, capacity=None):
        self.name = name
        self._state = state
        self._inflight = inflight
        self._alive = alive
        self.capacity = capacity
        self.submitted = []

    @property
    def alive(self):
        return self._alive

    @property
    def inflight(self):
        return self._inflight

    def health_state(self):
        return self._state if self._alive else "dead"

    def submit(self, request):
        if self.capacity is not None and self._inflight >= self.capacity:
            raise OverloadError(f"{self.name} full")
        self._inflight += 1
        self.submitted.append(request)
        return FakePending()


def test_least_loaded_dispatch_prefers_idle_replica():
    r0, r1 = FakeReplica("r0", inflight=3), FakeReplica("r1", inflight=1)
    Router([r0, r1]).submit(_req(_prompt(0), 4, GREEDY, 0))
    assert [len(r0.submitted), len(r1.submitted)] == [0, 1]
    r2, r3 = FakeReplica("r2"), FakeReplica("r3")  # a tie: the lowest index
    Router([r2, r3]).submit(_req(_prompt(0), 4, GREEDY, 0))
    assert [len(r2.submitted), len(r3.submitted)] == [1, 0]


def test_routes_around_degraded_draining_dead():
    degraded = FakeReplica("limping", state="degraded")
    busy = FakeReplica("busy", inflight=6)
    draining = FakeReplica("draining", state="draining")
    dead = FakeReplica("dead", alive=False)
    router = Router([degraded, busy, draining, dead])
    router.submit(_req(_prompt(0), 4, GREEDY, 0))
    assert len(busy.submitted) == 1 and not degraded.submitted
    busy._state = "draining"  # DEGRADED serves when nothing better accepts
    router.submit(_req(_prompt(0), 4, GREEDY, 1))
    assert len(degraded.submitted) == 1
    assert not draining.submitted and not dead.submitted
    degraded._state = "draining"
    with pytest.raises(RejectedError, match="no routable replica"):
        router.submit(_req(_prompt(0), 4, GREEDY, 2))


def test_fleet_admission_bound_sheds_with_overload_error():
    router = Router([FakeReplica("r0", inflight=2), FakeReplica("r1", inflight=2)],
                    max_inflight=4)
    with pytest.raises(OverloadError, match="fleet admission full"):
        router.submit(_req(_prompt(0), 4, GREEDY, 0))
    assert router.stats["shed"] == 1
    router2 = Router([FakeReplica("r2", inflight=1, capacity=1),
                      FakeReplica("r3", inflight=1, capacity=1)])
    with pytest.raises(OverloadError, match="every routable replica shed"):
        router2.submit(_req(_prompt(0), 4, GREEDY, 0))


def test_dispatch_fault_fails_over_to_next_replica():
    r0, r1 = FakeReplica("r0"), FakeReplica("r1")
    router = Router([r0, r1])
    plan = inject.FaultPlan().fail_io("fleet.dispatch")
    with inject.inject(plan):
        router.submit(_req(_prompt(0), 4, GREEDY, 0))
    assert plan.delivered == ["fleet.dispatch@1"]
    assert [len(r0.submitted), len(r1.submitted)] == [0, 1]
    assert router.stats["failovers"] == 1
    with inject.inject(inject.FaultPlan().fail_io("fleet.dispatch", times=-1)):
        with pytest.raises(RejectedError, match="every routable replica"):
            router.submit(_req(_prompt(0), 4, GREEDY, 1))


def test_session_turns_serialized_fleet_wide():
    r0, r1 = FakeReplica("r0"), FakeReplica("r1")
    router = Router([r0, r1])
    p1 = router.submit(_req(_prompt(0), 4, GREEDY, 0, sid="conv"))
    with pytest.raises(ValueError, match="one turn at a time"):
        router.submit(_cont(4, GREEDY, "conv"))
    p1.done.set()
    router.submit(_cont(4, GREEDY, "conv"))
    assert len(r0.submitted) + len(r1.submitted) == 2


def test_router_bookkeeping_holds_under_concurrent_submitters():
    """Many submitter threads (more than cores) with a short switch interval:
    every request placed exactly once, the router's counters and admission
    count consistent (a lost update under its lock would break them)."""
    import sys

    class Counting(FakeReplica):
        def __init__(self, name):
            super().__init__(name)
            self._lock = threading.Lock()

        def submit(self, request):
            with self._lock:
                self._inflight += 1
                self.submitted.append(request)
            return FakePending()

    replicas = [Counting(f"r{i}") for i in range(3)]
    router = Router(replicas)
    n_threads, per = min(len(os.sched_getaffinity(0)) + 4, 128), 25
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [router.submit(_req(_prompt(0), 1, GREEDY, 0))
                                                    for _ in range(per)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * per
    assert sum(len(r.submitted) for r in replicas) == router.stats["dispatched"] == total
    assert router._dispatching == 0 and router._dispatches == total


def test_replica_spawn_fault_is_retried():
    spawned = []

    def factory(name):
        r = FakeReplica(name)
        r.wait_ready = lambda timeout: None
        spawned.append(name)
        return r

    plan = inject.FaultPlan().fail_io("fleet.replica_spawn")
    with inject.inject(plan):
        sup = Supervisor(factory, 2, spawn_retry=FAST_RETRY).start()
    assert plan.delivered == ["fleet.replica_spawn@1"]
    assert spawned == ["replica-0.g2", "replica-1.g3"] and len(sup.replicas) == 2


# -- the autoscaler over scripted replicas ------------------------------------------------------


class ScriptedReplica(FakeReplica):
    """FakeReplica + the supervisor-facing lifecycle surface."""

    def __init__(self, name, **kw):
        super().__init__(name, **kw)
        self.last_status = None
        self.firing_fast = []
        self.drained = self.killed = False

    def wait_ready(self, timeout=0.0):
        return True

    def status(self, timeout=0.0):
        self.last_status = {"state": self._state, "reason": "",
                            "slo": {"firing_fast": list(self.firing_fast), "objectives": {},
                                    "actuate": False}}
        return self.last_status

    def drain(self):
        self.drained = True
        self._state = "draining"
        self._alive = False

    def join(self, timeout=0.0):
        return True

    def kill(self):
        self.killed = True
        self._alive = False


def _scripted_fleet(n, pol):
    made = []

    def factory(name):
        made.append(ScriptedReplica(name))
        return made[-1]

    return Supervisor(factory, n, autoscale=pol).start(), made


def test_autoscale_queue_pressure_hysteresis_and_cooldown():
    pol = AutoscalePolicy(min_replicas=1, max_replicas=3, queue_high=2.0, queue_low=1.0,
                          up_ticks=2, down_ticks=3, cooldown_ticks=2)
    sup, made = _scripted_fleet(1, pol)
    made[0]._inflight = 5
    sup.tick()
    assert len(sup.replicas) == 1 and sup.autoscale_state()["up_streak"] == 1
    sup.tick()
    assert len(sup.replicas) == 2 and any("scale_out (queue)" in e[2] for e in sup.events)
    sup.tick()
    sup.tick()
    assert len(sup.replicas) == 2, "no move inside the refractory window"
    sup.tick()
    assert len(sup.replicas) == 3
    made[1]._inflight = 3
    for _ in range(6):
        sup.tick()
    assert sup.autoscale_state()["queue_pressure"] is True and len(sup.replicas) == 3
    assert {r.name for r in sup.replicas} == {"replica-0.g1", "replica-1.g2", "replica-2.g3"}


def test_autoscale_scale_in_drains_least_loaded_respects_min():
    pol = AutoscalePolicy(min_replicas=1, max_replicas=3, queue_high=4.0, queue_low=1.0,
                          up_ticks=2, down_ticks=2, cooldown_ticks=0)
    sup, made = _scripted_fleet(2, pol)
    r0, r1 = made
    r0._inflight = 3
    sup.tick()
    sig = sup.autoscale_state()
    assert not sig["pressure"] and not sig["surplus"] and sig["down_streak"] == 0
    r0._inflight = 2
    sup.tick()
    assert len(sup.replicas) == 2
    sup.tick()
    assert len(sup.replicas) == 1 and sup.replicas[0] is r0
    assert r1.drained and not r1.killed
    r0._inflight = 0
    for _ in range(5):
        sup.tick()
    assert len(sup.replicas) == 1 and not r0.drained


def test_autoscale_burn_pressure_spawns_and_vetoes_surplus():
    pol = AutoscalePolicy(min_replicas=1, max_replicas=2, queue_high=8.0, queue_low=4.0,
                          up_ticks=1, down_ticks=1, cooldown_ticks=0)
    sup, made = _scripted_fleet(1, pol)
    made[0].firing_fast = ["latency_p99"]
    sup.tick()
    assert len(sup.replicas) == 2 and any("scale_out (burn)" in e[2] for e in sup.events)
    assert sup.autoscale_state()["burn_pressure"] is True
    for _ in range(3):
        sup.tick()
    assert len(sup.replicas) == 2
    made[0].firing_fast = []
    sup.tick()
    assert len(sup.replicas) == 1


# -- the Server's snapshot --------------------------------------------------------------------


def test_server_snapshot_atomic_and_complete(model):
    srv = Server(model, ServeConfig(chunk=4, slots=2))
    snap = srv.snapshot()
    assert {"state", "stats", "occupancy", "slots", "sessions", "queued", "slo",
            "capacity"} <= set(snap)
    assert {"prefilling", "decoding", "active", "free"} <= set(snap["slots"])
    entered, finished = threading.Event(), threading.Event()

    def flip():
        entered.set()
        srv.health.to(Health.SERVING, "probe")
        finished.set()

    with srv._stats_lock:
        threading.Thread(target=flip, daemon=True).start()
        assert entered.wait(timeout=5.0)
        assert not finished.wait(timeout=0.2), "a transition must wait for the snapshot reader"
    assert finished.wait(timeout=5.0) and srv.health.state is Health.SERVING
    srv.close()


# -- LocalReplica fleets: mobility, drain, kill, healing --------------------------------------


def test_cross_replica_session_resume_bitwise(model, tmp_path):
    prompt = _prompt(0)
    ref = _ref(model, prompt, 16, GREEDY, seed=123)
    sup = _local_fleet(model, tmp_path)
    try:
        p1 = _wait(sup.router.submit(_req(prompt, 8, GREEDY, 123, "conv")))
        assert p1.result.status == "ok"
        (served_by,) = [r for r in sup.replicas if r.server.stats["ok"] == 1]
        served_by.drain()
        assert served_by.join(timeout=30.0)
        p2 = _wait(sup.router.submit(_cont(8, GREEDY, "conv")))
        assert p2.result.status == "ok"
        (other,) = [r for r in sup.replicas if r is not served_by]
        assert other.server.stats["resumed"] == 1, "must resume on the other replica"
        np.testing.assert_array_equal(np.concatenate([p1.result.tokens, p2.result.tokens], 1), ref)
    finally:
        sup.drain_all(timeout=30.0)


def test_stale_resident_cache_revalidated_against_shared_store(model, tmp_path):
    prompt = _prompt(1)
    ref = _ref(model, prompt, 24, GREEDY, seed=9)
    sup = _local_fleet(model, tmp_path)
    a, b = sup.replicas
    try:
        p1 = _wait(a.submit(_req(prompt, 8, GREEDY, 9, "conv")))
        assert "conv" in a.server._sessions
        p2 = _wait(b.submit(_cont(8, GREEDY, "conv")))
        p3 = _wait(a.submit(_cont(8, GREEDY, "conv")))
        total = np.concatenate([p1.result.tokens, p2.result.tokens, p3.result.tokens], 1)
        np.testing.assert_array_equal(total, ref)
        assert a.server.session_store.newest_generation("conv") == 3
    finally:
        sup.drain_all(timeout=30.0)


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_drain_midstream_reroutes_continuation_bitwise(model, tmp_path, sample):
    want, prompt = 24, _prompt(10)
    ref = _ref(model, prompt, want, sample, seed=500)
    sup = _local_fleet(model, tmp_path)
    try:
        victim = sup.replicas[0]
        plan = inject.FaultPlan().add("serve.chunk", step=2, times=1, action=victim.drain)
        with inject.inject(plan):
            p1 = _wait(sup.router.submit(_req(prompt, want, sample, 500, "conv")))
        assert plan.delivered and p1.result.status == "suspended"
        assert 0 < p1.result.new_tokens < want, "must suspend mid-stream"
        assert victim.join(timeout=30.0)
        sup.tick()
        assert all(r.alive for r in sup.replicas) and victim not in sup.replicas
        p2 = _wait(sup.router.submit(_cont(want - p1.result.new_tokens, sample, "conv")))
        assert p2.result.status == "ok"
        np.testing.assert_array_equal(np.concatenate([p1.result.tokens, p2.result.tokens], 1), ref)
    finally:
        sup.drain_all(timeout=30.0)


def test_killed_replica_mid_turn_last_generation_survives(model, tmp_path):
    prompt = _prompt(11)
    ref = _ref(model, prompt, 16, GREEDY, seed=17)
    sup = _local_fleet(model, tmp_path)
    try:
        victim = sup.replicas[0]
        p1 = _wait(sup.router.submit(_req(prompt, 8, GREEDY, 17, "conv")))
        assert p1.result.status == "ok"
        plan = inject.FaultPlan().add("serve.chunk", step=2, times=1, action=victim.kill)
        with inject.inject(plan):
            p2 = _wait(sup.router.submit(_cont(8, GREEDY, "conv")))
        assert plan.delivered and p2.result is not None and p2.result.status == "failed"
        assert victim.crashed and victim.join(timeout=30.0)
        sup.tick()
        assert all(r.alive for r in sup.replicas)
        p3 = _wait(sup.router.submit(_cont(8, GREEDY, "conv")))
        assert p3.result.status == "ok"
        np.testing.assert_array_equal(np.concatenate([p1.result.tokens, p3.result.tokens], 1), ref)
    finally:
        sup.drain_all(timeout=30.0)


def test_supervisor_drains_and_respawns_degraded_replica(model, tmp_path):
    sup = _local_fleet(model, tmp_path)
    try:
        victim = sup.replicas[0]
        with inject.inject(inject.FaultPlan().poison_decode_state_at(chunk=0, times=-1)):
            p = _wait(sup.router.submit(_req(_prompt(12), 8, GREEDY, 0)))
        assert p.result is not None and p.result.status == "failed"
        assert victim.health_state() == "degraded"
        sup.tick()
        assert victim not in sup.replicas and victim.join(timeout=30.0)
        assert victim.server.health.state is Health.DEAD
        assert all(r.alive for r in sup.replicas)
        assert any("degraded; draining" in e[2] for e in sup.events)
        p2 = _wait(sup.router.submit(_req(_prompt(13), 4, GREEDY, 1)))
        assert p2.result.status == "ok"
    finally:
        sup.drain_all(timeout=30.0)


class ScriptedStatusReplica(FakeReplica):
    """FakeReplica plus a scripted (state, reason) heartbeat."""

    def __init__(self, name, state="serving", reason=""):
        super().__init__(name, state=state)
        self.reason = reason
        self.drained = self.killed = False

    def wait_ready(self, timeout):
        pass

    def status(self, timeout=2.0):
        return {"state": self.health_state(), "reason": self.reason}

    def drain(self):
        self.drained = True
        self._alive = False
        self._state = "dead"

    def kill(self):
        self.killed = True
        self._alive = False

    def join(self, timeout=0.0):
        return not self._alive


def test_supervisor_suppresses_respawn_for_store_outage():
    spawned = []

    def factory(name):
        spawned.append(ScriptedStatusReplica(name))
        return spawned[-1]

    sup = Supervisor(factory, 1, spawn_retry=FAST_RETRY, drain_grace=0.1).start()
    r0 = spawned[0]
    r0._state, r0.reason = "degraded", "store-outage:session"
    sup.tick()
    sup.tick()
    assert sup.replicas[0] is r0 and not r0.drained and not r0.killed and len(spawned) == 1
    msgs = [e[2] for e in sup.events]
    assert sum("respawn_suppressed" in m for m in msgs) == 1
    r0._state, r0.reason = "serving", ""
    sup.tick()
    r0._state, r0.reason = "degraded", "store-outage:prefix"
    sup.tick()
    assert sum("respawn_suppressed" in e[2] for e in sup.events) == 2 and len(spawned) == 1
    r0.reason = "watchdog: serve loop stalled"
    sup.tick()
    assert r0.drained and sup.replicas[0] is not r0 and len(spawned) == 2


def test_fleet_overload_shed_integration(model, tmp_path):
    sup = _local_fleet(model, tmp_path, sup_kw={"max_inflight": 1})
    try:
        p1 = sup.router.submit(_req(_prompt(14), 16, GREEDY, 0))
        with pytest.raises(OverloadError, match="fleet admission full"):
            sup.router.submit(_req(_prompt(15), 4, GREEDY, 1))
        _wait(p1)
        assert _wait(sup.router.submit(_req(_prompt(15), 4, GREEDY, 1))).result.status == "ok"
    finally:
        sup.drain_all(timeout=30.0)


def test_fleet_aggregates_capacity_and_cost(model, tmp_path):
    """The aggregated view over the status op: the fleet capacity from the
    summed gauges and the attribution counters of both replicas."""
    sup = _local_fleet(model, tmp_path, prefill_chunk=8)
    try:
        ps = [sup.router.submit(_req(_prompt(40 + i), 8, GREEDY, i)) for i in range(4)]
        for p in ps:
            assert p.wait(timeout=60.0) is not None
        agg = sup.aggregate_metrics()
        cap = agg["capacity"]
        assert cap["replicas_reporting"] == 2 and 0.0 <= cap["headroom"] <= 1.0
        flat = {r["name"]: r["value"] for r in agg["counters"] if not r["labels"]}
        assert flat["attributed_ms_total"] > 0 and flat["decode_tokens_total"] == 4 * 8
    finally:
        sup.drain_all(timeout=30.0)


# -- the CLI ------------------------------------------------------------------------------------


_SETS = ["--set", "d_model=32", "--set", "n_layers=1", "--set", "n_heads=2", "--set",
         "max_seq_len=64"]


def test_fleet_cli_local_roundtrip(tmp_path, capsys):
    pf = tmp_path / "prompts.txt"
    pf.write_text("ab\ncd\n")
    rc = fleet_cli.main(["--local", "--replicas", "2", "--config", "tiny", *_SETS,
                         "--prompts-file", str(pf), "--max-new-tokens", "4", "--chunk", "2",
                         "--slots", "2", "--prefill-chunk", "0", "--temperature", "0",
                         "--session-dir", str(tmp_path / "store"), "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 2 and all(ln.startswith(("ab", "cd")) for ln in lines)
    assert "fleet:" in out.err and "fleet capacity:" in out.err


def test_fleet_cli_continues_a_drained_turn_bitwise(tmp_path, capsys, monkeypatch):
    """A session turn whose replica drains mid-stream comes back suspended;
    the CLI continues it through the router on the other replica and its
    line is bitwise the undrained run's."""
    pf = tmp_path / "prompts.txt"
    pf.write_text("a fleet prompt\n")
    args = ["--local", "--replicas", "2", "--config", "tiny", *_SETS, "--prompts-file", str(pf),
            "--max-new-tokens", "12", "--chunk", "2", "--slots", "2", "--prefill-chunk", "0",
            "--temperature", "0", "--device", "cpu", "--session-id", "conv"]
    assert fleet_cli.main(args + ["--session-dir", str(tmp_path / "s1")]) == 0
    want = capsys.readouterr().out
    made = []
    real = fleet_cli.LocalReplica

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(fleet_cli, "LocalReplica", spy)
    plan = inject.FaultPlan().add("serve.chunk", step=2, times=1,
                                  action=lambda: made[0].drain())
    with inject.inject(plan):
        assert fleet_cli.main(args + ["--session-dir", str(tmp_path / "s2")]) == 0
    out = capsys.readouterr()
    assert plan.delivered and "continued after a drain" in out.err
    assert out.out == want and "[suspended]" not in out.out


@pytest.mark.parametrize("flag,value,item", [("--tp", "2", "A12"), ("--exec-dir", "x", "A13")])
def test_fleet_cli_refuses_unported_flags(flag, value, item):
    with pytest.raises(NotImplementedError, match=item):
        fleet_cli.main(["--local", "--device", "cpu", flag, value, "--prompts-file", os.devnull])
