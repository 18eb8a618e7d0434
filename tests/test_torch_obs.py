"""The port's host telemetry and resilience copies (``orion_tpu_torch/obs/``,
``resilience/{preempt,watchdog,inject}.py``, ``serving/locks.py``) on the
CPU:

- against the JAX package: the same operations on both ``MetricsRegistry``
  give byte-equal Prometheus text, snapshots and dump files (``aggregate``
  and ``snapshot_value`` too); the same calls on both ``Tracer`` give equal
  events and ``span_pairs``, and equal merged documents;
- the reference's contracts from ``tests/test_obs.py`` :129-296 (registry,
  tracer, flight ring, the inject subscription), :319 and :352 (the Server's
  stats in the registry, occupancy now and lifetime), :406 (a chaos run:
  every span paired, chunk events inside their request, flight dumps at
  every trigger carrying the fired sites), :528's counterpart (no host read,
  in ``tests/test_torch_server.py``), the watchdog stall dump, and
  ``tests/test_resilience.py`` :244-306 (watchdog, PreemptionGuard);
- ``serving/locks.py``: every declared site and guarded field is an attribute
  assignment in its module, aliases are real sites, ORDER is acyclic.
"""

import ast
import json
import math
import os
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from orion_tpu.obs import metrics as jax_metrics
from orion_tpu.obs import trace as jax_trace
from orion_tpu_torch import generate as gen
from orion_tpu_torch.obs import metrics, trace
from orion_tpu_torch.obs.flight import FlightRecorder
from orion_tpu_torch.obs.metrics import MetricsRegistry, aggregate, prometheus_from_snapshot
from orion_tpu_torch.obs.trace import Tracer, merge_traces, read_jsonl, span_pairs
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.resilience.preempt import PreemptionGuard
from orion_tpu_torch.resilience.watchdog import StallError, Watchdog
from orion_tpu_torch.serving import DecodeRequest, Health, ServeConfig, Server, locks
from torch_serving_common import GREEDY, prompt, torch_model

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _cfg(**kw):
    kw.setdefault("chunk", 4)
    kw.setdefault("slots", 2)
    kw.setdefault("max_inflight", 8)
    kw.setdefault("prefill_buckets", "8,16,32")
    kw.setdefault("prefill_chunk", 8)
    return ServeConfig(**kw)


def _solo(model, p, new, seed):
    return gen.generate(model, torch.from_numpy(p), new, GREEDY, seed).numpy()


# -- the registry against the JAX package's ------------------------------------------


def _drive_registry(mod, tmp_path, tag):
    """The same operations on ``mod.MetricsRegistry`` -> (registry, dump path)."""
    now = [0.0]
    r = mod.MetricsRegistry(clock=lambda: now[0])
    r.counter("ok").inc()
    r.counter("ok").inc(2)
    r.counter("ladder_rungs").inc(labels={"rung": "rewind"})
    r.counter("ladder_rungs").inc(3, labels={"rung": "re-prefill"})
    r.gauge("depth").set(5)
    r.gauge("depth").inc(0.25, labels={"q": "a b"})
    r.gauge_fn("live", lambda: 7, labels={"cache": "decode"})
    r.gauge_fn("broken", lambda: 1 / 0)
    h = r.histogram("lat_ms", buckets=(1, 10, 100))
    for v in (0.5, 10, 5000, 99.5):
        h.observe(v)
    d = r.histogram("chunk_ms")
    for v in (0.3, 3.0, 17.25, 250.0, 1e6):
        d.observe(v, labels={"tp": "1"} if v > 1 else None)
    now[0] = 12.5
    path = str(tmp_path / tag / "m.prom")
    r.dump(path)
    return r, path


def test_registry_byte_equal_to_the_jax_registry(tmp_path):
    ours, p_ours = _drive_registry(metrics, tmp_path, "port")
    ref, p_ref = _drive_registry(jax_metrics, tmp_path, "jax")
    assert json.dumps(ours.snapshot()) == json.dumps(ref.snapshot())
    assert ours.to_prometheus() == ref.to_prometheus()
    for suffix in ("", ".json"):
        assert Path(p_ours + suffix).read_bytes() == Path(p_ref + suffix).read_bytes()
    assert ours.counters_flat() == ref.counters_flat()
    for name in ("lat_ms", "chunk_ms"):
        assert ours.histogram(name).cell_total() == ref.histogram(name).cell_total()
    assert ours.histogram("chunk_ms").cell({"tp": "1"}) == ref.histogram("chunk_ms").cell(
        {"tp": "1"})
    snaps, jsnaps = [ours.snapshot()] * 2, [ref.snapshot()] * 2
    agg, jagg = aggregate(snaps, ["a", "b"]), jax_metrics.aggregate(jsnaps, ["a", "b"])
    assert json.dumps(agg) == json.dumps(jagg)
    assert prometheus_from_snapshot(agg) == jax_metrics.prometheus_from_snapshot(jagg)
    for name, labels in (("ok", None), ("ladder_rungs", None), ("ladder_rungs", {"rung": "rewind"}),
                         ("depth", {"q": "a b"}), ("missing", None)):
        assert metrics.snapshot_value(agg, name, labels) == jax_metrics.snapshot_value(
            jagg, name, labels)


def test_registry_counters_gauges_histograms_and_prometheus():
    r = MetricsRegistry()
    r.counter("ok").inc(3)
    h = r.histogram("lat_ms", buckets=(1, 10, 100))
    for v in (0.5, 10, 5000):
        h.observe(v)
    (hist,) = r.snapshot()["histograms"]
    assert hist["count"] == 3 and hist["counts"] == [1, 1, 0, 1] and hist["buckets"][-1] == "+Inf"
    text = r.to_prometheus()
    assert "# TYPE ok counter" in text and "ok 3" in text
    assert 'lat_ms_bucket{le="+Inf"} 3' in text and "lat_ms_count 3" in text
    assert r.histogram("x", buckets=(1, 2)).buckets == (1, 2, math.inf)


def test_registry_snapshot_is_one_consistent_read():
    r = MetricsRegistry()
    c = r.counter("events")
    r.gauge_fn("events_gauge", lambda: r._counters["events"].get((), 0))
    c.inc(41)
    snap = r.snapshot()
    counter = [x for x in snap["counters"] if x["name"] == "events"][0]
    gauge = [x for x in snap["gauges"] if x["name"] == "events_gauge"][0]
    assert counter["value"] == gauge["value"] == 41


# -- the tracer against the JAX package's ---------------------------------------------


def _drive_tracer(mod, path):
    now = [1.0]
    tr = mod.Tracer(path=path, clock=lambda: now[0], pid=7)
    tr.begin("request", "req-1", session="conv")
    tr.begin("queue", "req-1")
    now[0] = 1.01
    tr.end("queue", "req-1")
    tr.complete("decode_chunk", 1.005, 0.004, req="req-1", slot=0, chunk=0)
    tr.instant("ladder", id="req-1", rung="rewind")
    tr.begin("request", "req-2")
    now[0] = 1.02
    tr.end("request", "req-1", status="ok")
    tr.end("request", "req-2", status="shed")
    n = tr.flush()
    tr.begin("turn", "conv:1", cat="fleet", session="conv")
    tr.end("turn", "conv:1", cat="fleet", status="ok")
    tr.close()
    return n


def test_tracer_events_and_span_pairs_equal_the_jax_tracer(tmp_path):
    a, b = str(tmp_path / "port" / "t.jsonl"), str(tmp_path / "jax" / "t.jsonl")
    assert _drive_tracer(trace, a) == _drive_tracer(jax_trace, b) == 8
    ours, ref = read_jsonl(a), jax_trace.read_jsonl(b)
    assert ours == ref and len(ours) == 10
    assert span_pairs(ours) == jax_trace.span_pairs(ref)
    pairs = span_pairs(ours)
    assert all(len(p["b"]) == len(p["e"]) == 1 for p in pairs.values())
    out_a, out_b = str(tmp_path / "ma.json"), str(tmp_path / "mb.json")
    assert merge_traces([a, str(tmp_path / "missing")], out_a) == 10
    jax_trace.merge_traces([b, str(tmp_path / "missing")], out_b)
    assert Path(out_a).read_text() == Path(out_b).read_text()
    assert trace.main(["merge", a, "-o", str(tmp_path / "cli.json")]) == 0
    assert json.loads((tmp_path / "cli.json").read_text())["traceEvents"] == json.loads(
        Path(out_a).read_text())["traceEvents"]


def test_tracer_disabled_is_inert_and_ring_is_bounded():
    tr = Tracer(path=None, enabled=False)
    tr.begin("request", "x")
    assert tr.events() == [] and tr.flush() == 0
    small = Tracer(path=None, capacity=4)
    for i in range(10):
        small.instant("e", i=i)
    assert len(small.events()) == 4 and small.dropped == 6


# -- the flight recorder ----------------------------------------------------------------


def test_flight_ring_bounded_dump_and_triggers(tmp_path):
    now = [5.0]
    rec = FlightRecorder(capacity=3, clock=lambda: now[0], dump_dir=str(tmp_path / "fl"))
    for i in range(5):
        rec.record("beat", i=i)
    assert [e["i"] for e in rec.events()] == [2, 3, 4] and rec.dropped == 2
    p1 = rec.dump("health-degraded")
    now[0] = 6.0
    rec.record_signal_safe("beat", i=99)
    p2 = rec.dump("health-degraded")
    assert p1 != p2, "each trigger writes its own file"
    other = FlightRecorder(dump_dir=str(tmp_path / "fl"))
    other.record("beat", i=-1)
    assert other.dump("health-degraded") not in (p1, p2)
    doc = json.loads(Path(p2).read_text())
    assert doc["reason"] == "health-degraded" and doc["dropped"] == 2
    assert doc["events"][-1]["i"] == 99 and rec.dumps == [p1, p2]
    assert FlightRecorder().dump("x") is None  # no dump_dir: ring only
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=0)


def test_flight_configure_swaps_the_default_recorder(tmp_path):
    from orion_tpu_torch.obs import flight

    before = flight.recorder()
    try:
        rec = flight.configure(dump_dir=str(tmp_path), capacity=5)
        assert flight.recorder() is rec and rec.capacity == 5 and rec.dump_dir == str(tmp_path)
        flight.record("x", a=1)
        assert rec.dump("r") and rec.events("x")[0]["a"] == 1
    finally:
        flight._default = before


def test_flight_subscribes_to_inject_deliveries():
    rec = FlightRecorder()
    rec.attach_inject()
    try:
        with inject.inject(inject.FaultPlan().add("serve.chunk", step=3)):
            inject.fire("serve.chunk", step=2)  # not armed at 2: no delivery
            inject.fire("serve.chunk", step=3)
    finally:
        rec.detach_inject()
    assert [(e["site"], e["step"]) for e in rec.events("fault")] == [("serve.chunk", 3)]
    with inject.inject(inject.FaultPlan().add("serve.chunk")):
        inject.fire("serve.chunk", step=0)
    assert len(rec.events("fault")) == 1, "detached: no further events"


def test_every_registered_site_delivery_leaves_flight_event():
    """Site <-> event parity: a delivery at any wired site (the markers
    ``train.nan``, ``decode.state_nan`` and the per-slot family included,
    each reached through its query) leaves a ``fault`` event in an attached
    ring."""
    sites = sorted(inject.SITES) + ["decode.slot_nan.3"]
    rec = FlightRecorder()
    rec.attach_inject()
    try:
        plan = inject.FaultPlan()
        for site in sites:
            plan.add(site, step=1)
        with inject.inject(plan):
            for site in sites:
                if site.startswith("decode.slot_nan."):
                    assert inject.decode_slot_nan_armed(3, 1)
                elif site == "decode.state_nan":
                    assert inject.decode_nan_armed(1)
                elif site == "train.nan":  # a marker, consumed as Trainer.step does
                    assert inject.nan_armed(1)
                else:
                    inject.fire(site, step=1)
    finally:
        rec.detach_inject()
    assert {e["site"] for e in rec.events("fault")} == set(sites)
    with pytest.raises(ValueError, match="unknown fault-injection site"):
        inject.FaultPlan().add("serve.chunk_dealy")


def test_fail_io_and_delay_chunk_actions():
    plan = inject.FaultPlan().fail_io("serve.ckpt_load", step=2, exc=IOError, msg="disk")
    plan.delay_chunk(0.02, chunk=5)
    with inject.inject(plan):
        inject.fire("serve.ckpt_load", step=1)  # another step: nothing
        with pytest.raises(IOError, match=r"disk \[site=serve.ckpt_load\]"):
            inject.fire("serve.ckpt_load", step=2)
        t = time.perf_counter()
        inject.fire("serve.chunk_delay", step=5)
        assert time.perf_counter() - t >= 0.02
    assert plan.delivered == ["serve.ckpt_load@2", "serve.chunk_delay@5"]


# -- the Server's telemetry -------------------------------------------------------------


def test_server_stats_ride_the_registry(model):
    """test_obs.py :319: the stats contract in the registry, the queue and
    slot gauges, chunk_ms one observation a boundary, the Prometheus text."""
    srv = Server(model, _cfg())
    for i in range(3):
        srv.submit(DecodeRequest(prompt(i, 5), 8, GREEDY, seed=i))
    assert srv.serve(drain_when_idle=True) == 0
    assert srv.stats["ok"] == 3 and srv.stats["admitted"] == 3
    snap = srv.snapshot()
    assert snap["stats"]["ok"] == 3
    m = snap["metrics"]
    gauges = {(g["name"], tuple(sorted(g["labels"].items()))): g["value"] for g in m["gauges"]}
    assert gauges[("queue_depth", ())] == 0
    assert gauges[("slots", (("state", "active"),))] == 0
    assert gauges[("slots", (("state", "free"),))] == 2
    hists = {h["name"]: h for h in m["histograms"]}
    assert hists["chunk_ms"]["count"] == srv.stats["chunks"] > 0
    assert hists["turn_latency_ms"]["count"] == 3
    text = srv.metrics.to_prometheus()
    assert "# TYPE ok counter" in text and "chunk_ms_bucket" in text
    assert 'health_transitions{to="serving"} 1' in text
    srv.close()


def test_occupancy_instantaneous_vs_lifetime(model):
    """test_obs.py :352."""
    srv = Server(model, _cfg())
    assert srv.occupancy() == 0.0 and srv.occupancy_lifetime() == 0.0
    seen = []
    real_step = srv.engine.step

    def spying_step():
        seen.append(srv.occupancy())
        return real_step()

    srv.engine.step = spying_step
    srv.submit(DecodeRequest(prompt(0, 5), 8, GREEDY, seed=0))
    assert srv.serve(drain_when_idle=True) == 0
    assert seen and max(seen) == 0.5, "1 of 2 slots live mid-run"
    assert srv.occupancy() == 0.0 and 0.0 < srv.occupancy_lifetime() <= 1.0
    srv.close()


def test_chaos_run_trace_complete_and_flight_dumps(model, tmp_path):
    """test_obs.py :406, without the session turns (A8 step 3): two requests
    admitted in-scan, the second poisoned twice at its chunk 2 (rung 2,
    completing degraded), a third queued; SIGTERM at boundary 4 drains. Every
    request bitwise its solo tokens; every span pairs exactly once; every
    chunk event nests in its request's span, prefill pieces and decode
    chunks both; ladder instants; flight dumps at DEGRADED, DRAINING and
    DEAD, the drain's carrying the fired sites; the metrics dumped on drain."""
    trace_path, flight_dir = str(tmp_path / "trace.jsonl"), str(tmp_path / "flight")
    tracer = Tracer(path=trace_path, clock=time.monotonic)
    cfg = _cfg(flight_dir=flight_dir, metrics_path=str(tmp_path / "m.prom"),
               metrics_interval_s=0.0)
    reqs = [(prompt(0, 13), 24, 7), (prompt(1, 4), 16, 8), (prompt(2, 6), 8, 9)]
    srv = Server(model, cfg, tracer=tracer)
    ps = [srv.submit(DecodeRequest(p, n, GREEDY, seed=s)) for p, n, s in reqs]
    plan = inject.FaultPlan().poison_decode_slot_at(1, 2, times=2).preempt_at_chunk(4)
    with inject.inject(plan):
        assert srv.serve() == 0
    assert srv.health.state is Health.DEAD
    for (p, n, s), pend in zip(reqs, ps):
        assert pend.result.status == "ok"
        np.testing.assert_array_equal(pend.result.tokens, _solo(model, p, n, s))
    assert (ps[1].result.rewinds, ps[1].result.reprefills) == (1, 1)
    assert "ladder_rungs" in Path(cfg.metrics_path).read_text()

    events = read_jsonl(trace_path)
    pairs = span_pairs(events)
    req_spans = {k[1]: v for k, v in pairs.items() if k[2] == "request"}
    assert len(req_spans) == 3 and len(pairs) == 6
    for key, pair in pairs.items():
        assert len(pair["b"]) == len(pair["e"]) == 1, key
    chunk_events = [e for e in events if e["ph"] == "X"]
    for ev in chunk_events:
        b, e = req_spans[ev["args"]["req"]]["b"][0], req_spans[ev["args"]["req"]]["e"][0]
        assert b["ts"] <= ev["ts"] and ev["ts"] + ev["dur"] <= e["ts"]
    assert {e["name"] for e in chunk_events} == {"prefill_piece", "decode_chunk"}
    ladder = [e for e in events if e["name"] == "ladder"]
    assert [e["args"]["rung"] for e in ladder] == ["rewind", "reprefill"]

    dumps = sorted(os.listdir(flight_dir))
    reasons = {d.split("-", 3)[3].rsplit(".", 1)[0] for d in dumps}
    assert {"health-degraded", "health-draining", "health-dead"} <= reasons, dumps
    drain = [d for d in dumps if "health-draining" in d][0]
    doc = json.loads((Path(flight_dir) / drain).read_text())
    assert {e["site"] for e in doc["events"] if e["kind"] == "fault"} >= {
        "decode.slot_nan.1", "serve.chunk"}
    assert {"admit", "ladder", "health", "prefill_piece", "evict"} <= {
        e["kind"] for e in doc["events"]}


def test_ladder_exhaustion_dumps_flight(model, tmp_path):
    srv = Server(model, _cfg(flight_dir=str(tmp_path / "fl")))
    srv.submit(DecodeRequest(prompt(0, 5), 8, GREEDY, seed=0))
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(0, 1, times=-1)):
        assert srv.serve(drain_when_idle=True) == 0
    assert srv.stats["failed"] == 1
    assert any("ladder-exhausted" in d for d in os.listdir(tmp_path / "fl"))
    assert [e for e in srv.flight.events("ladder") if e["rung"] == "exhausted"]
    srv.close()


def test_watchdog_stall_dumps_flight(model, tmp_path):
    fl = str(tmp_path / "fl")
    srv = Server(model, _cfg(stall_timeout=0.3, flight_dir=fl))
    real_step = srv.engine.step
    stalled = []

    def wedged_step():
        if not stalled:
            stalled.append(1)
            time.sleep(1.0)  # no beat for > stall_timeout
        return real_step()

    srv.engine.step = wedged_step
    srv.submit(DecodeRequest(prompt(0, 5), 8, GREEDY, seed=0))
    assert srv.serve(drain_when_idle=True) == 0
    assert srv.stats["stalls"] >= 1
    stall = [d for d in os.listdir(fl) if "watchdog-stall" in d]
    doc = json.loads((Path(fl) / stall[0]).read_text())
    assert any(e["kind"] == "watchdog" and e.get("event") == "stall" for e in doc["events"])
    srv.close()


def test_delay_chunk_lands_in_chunk_ms(model):
    """serve.chunk_delay fires inside the timed window: the delayed boundary
    is one chunk_ms observation of at least the delay."""
    srv = Server(model, _cfg())
    srv.submit(DecodeRequest(prompt(0, 5), 8, GREEDY, seed=0))
    plan = inject.FaultPlan().delay_chunk(0.25, chunk=2)
    with inject.inject(plan):
        srv.serve(drain_when_idle=True)
    assert plan.delivered == ["serve.chunk_delay@2"]
    cell = srv._h_chunk_ms.cell()
    assert cell["count"] == srv.stats["chunks"]
    assert cell["counts"][metrics.DEFAULT_MS_BUCKETS.index(500)] >= 1  # (200, 500] ms
    assert cell["sum"] >= 250.0
    srv.close()


# -- watchdog and PreemptionGuard (test_resilience.py :244-306) ----------------------------


def test_watchdog_manual_fake_clock():
    now = [0.0]
    wd = Watchdog(timeout=5.0, clock=lambda: now[0], monitor=False, label="step")
    wd.beat()
    now[0] = 4.0
    wd.check()
    wd.beat()
    now[0] = 10.0
    with pytest.raises(StallError, match="no heartbeat"):
        wd.check()
    wd.beat()
    now[0] = 11.0
    wd.check()
    wd.disarm()
    now[0] = 100.0
    wd.check()
    wd.close()


def test_watchdog_monitor_thread_invokes_on_stall_and_escalates():
    fired, seen = [], []
    wd = Watchdog(timeout=0.12, on_stall=fired.append, monitor=True, poll_interval=0.02,
                  label="wedged step", observer=lambda ev, d: seen.append(ev))
    try:
        wd.beat()
        deadline = time.monotonic() + 5.0
        while len(fired) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(fired) >= 2, "the stall persisted but never escalated"
        assert "wedged step" in fired[0] and "attempt 1" in fired[0] and "attempt 2" in fired[1]
        assert wd.last_stall in fired and "stall" in seen and "beat" in seen
        wd.beat()
        assert wd.trip_attempt == 0
    finally:
        wd.close()
    assert not wd._thread.is_alive()


def test_preemption_guard_graceful_then_hard():
    with PreemptionGuard(grace=30.0) as guard:
        assert not guard.should_stop
        signal.raise_signal(signal.SIGTERM)  # the handler runs synchronously
        assert guard.should_stop and guard.signum == signal.SIGTERM
        assert 0.0 < guard.remaining_grace() <= 30.0
    assert signal.getsignal(signal.SIGTERM) is not guard._handle
    with PreemptionGuard(grace=30.0) as guard:
        signal.raise_signal(signal.SIGINT)
        assert guard.should_stop
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGINT)
    stops = []
    g = PreemptionGuard(on_stop=stops.append)
    g.request_stop()
    g.request_stop()
    assert g.should_stop and stops == [signal.SIGTERM]


def test_guard_off_the_main_thread_warns_and_takes_request_stop():
    out = {}

    def run():
        with pytest.warns(UserWarning, match="not the main thread"):
            with PreemptionGuard() as g:
                g.request_stop(signal.SIGINT)
                out["stop"] = (g.should_stop, g.signum)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and out["stop"] == (True, signal.SIGINT)


# -- locks.py --------------------------------------------------------------------------------


def _assignments(module: str):
    """{(scope, name)} of every attribute or name assigned in ``module``:
    ``self.x = ...`` inside class C's methods as (C, x), a module-level or
    function-local ``x = ...`` as ('' or the function, x)."""
    tree = ast.parse((ROOT / module).read_text())
    out = set()

    def targets(node):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            return node.targets if isinstance(node, ast.Assign) else [node.target]
        return []

    def walk(node, scope, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name, child.name)
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(child, cls or child.name, cls)
                continue
            if isinstance(child, ast.Global):
                out.update(("", n) for n in child.names)
            for t in targets(child):
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Attribute) and isinstance(sub.value, ast.Name) and \
                            sub.value.id == "self":
                        out.add((cls, sub.attr))
                    elif isinstance(sub, ast.Name):
                        out.add((scope if cls is None else cls, sub.id))
            walk(child, scope, cls)

    walk(tree, "", None)
    return out


def test_locks_declarations_resolve_and_order_is_acyclic():
    assert set(locks.LOCKS) >= {"server.stats", "server.admission", "obs.trace", "obs.flight",
                                "watchdog.lock", "inject.plan"}
    for decl in locks.LOCKS.values():
        for site in (decl.site, *decl.aliases):
            assert (site.scope, site.attr) in _assignments(site.module), (decl.name, site)
        for g in decl.guards:
            assigned = _assignments(g.module)
            for f in g.fields:
                assert (g.scope, f) in assigned, (decl.name, g.module, g.scope, f)
    names = set(locks.LOCKS)
    assert all(a in names and b in names for a, b in locks.ORDER)
    succ = {}
    for a, b in locks.ORDER:
        succ.setdefault(a, set()).add(b)

    def reach(n, seen=()):
        assert n not in seen, f"cycle through {n}"
        for m in succ.get(n, ()):
            reach(m, seen + (n,))

    for n in names:
        reach(n)
    # data only: it imports none of the modules it declares
    assert not [line for line in (ROOT / "orion_tpu_torch/serving/locks.py").read_text()
                .splitlines() if line.startswith(("import", "from")) and "orion_tpu" in line]


def test_obs_modules_import_neither_torch_nor_jax():
    for mod in ("metrics", "trace", "flight"):
        src = (ROOT / "orion_tpu_torch" / "obs" / f"{mod}.py").read_text()
        for banned in ("import torch", "import jax", "from jax", "from torch"):
            assert banned not in src, (mod, banned)
