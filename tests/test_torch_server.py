"""The port's ``Server`` and its CLI (``orion_tpu_torch/serving/server.py``,
``__main__.py``) on the CPU, at the in-scan suite's tiny widths (one
linear, one softmax and one swa layer):

- against the JAX package's ``Server``: the same greedy requests into 4
  slots, by host and by in-scan admission: tokens equal, ``stats`` equal key
  by key, health edges equal (sampled runs are held inside the port only:
  its counter hash is not threefry);
- the reference's server contracts, bitwise inside the port (each request
  against the port's one-row ``generate`` at its seed), from
  ``tests/test_serving.py`` :76-376 (health machine, deadline anchored at
  submit, a real SIGTERM drain, shedding, the ladder through the server,
  isolation, the watchdog, the loaders' retries through ``fail_io``, the CLI)
  and ``tests/test_batching.py`` :370 (SIGTERM mid-batch), :530 (abnormal
  loop exit) and :564 (occupancy);
- feeder threads submitting while ``serve()`` runs; the Server adds no read
  of the device beyond the engine's own; refusals: every unported
  ``ServeConfig`` field and CLI flag, and more slots than ``DECODE_ROWS``
  (C1).
"""

import collections
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from orion_tpu.serving import DecodeRequest as JaxDecodeRequest
from orion_tpu.serving import ServeConfig as JaxServeConfig
from orion_tpu.serving import Server as JaxServer
from orion_tpu_torch import generate as gen
from orion_tpu_torch.models import transformer
from orion_tpu_torch.models.transformer import DECODE_ROWS, TransformerLM
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.resilience.preempt import PreemptionGuard
from orion_tpu_torch.resilience.retry import RetryPolicy
from orion_tpu_torch.serving import (DecodeRequest, Health, HealthMachine, InvalidTransition,
                                     OverloadError, RejectedError, ServeConfig, Server,
                                     SlotEngine, load_tokenizer)
from orion_tpu_torch.serving import server as server_mod
from orion_tpu_torch.serving.__main__ import _NOT_PORTED_FLAGS
from orion_tpu_torch.serving.__main__ import main as cli_main
from orion_tpu_torch.training.checkpoint import Checkpointer, load_params
from torch_serving_common import (CFG, GREEDY, SAMPLED, jax_model, jax_params, jax_sample,
                                  prompt, torch_model)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_RETRY = RetryPolicy(attempts=4, base_delay=0.01, max_delay=0.05)
BUCKETS = "8,16,32"


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _cfg(mode="host", **kw):
    kw.setdefault("chunk", 4)
    kw.setdefault("slots", 2)
    kw.setdefault("max_inflight", 8)
    return ServeConfig(prefill_buckets=BUCKETS, prefill_chunk=8 if mode == "inscan" else 0, **kw)


def _req(p, new=8, sample=GREEDY, seed=0, **kw):
    return DecodeRequest(p, new, sample, seed=seed, **kw)


def _solo(model, p, new, sample, seed):
    return gen.generate(model, torch.from_numpy(p), new, sample, seed).numpy()


def _prompts(n):
    """Prompts of 3..7 tokens: the slots sit at different positions."""
    return [prompt(100 + i, 3 + i % 5) for i in range(n)]


def _edges(health):
    return [(a.value if a else None, b.value) for a, b, _, _ in health.history]


# -- against the JAX package's Server -------------------------------------------


@pytest.mark.parametrize("mode", ["host", "inscan"])
def test_server_matches_the_jax_server(model, mode):
    """5 greedy requests submitted up front into 4 slots (prompts in two
    buckets): tokens equal, stats equal key by key, health edges equal."""
    lengths = [3, 8, 9, 13, 5]
    prompts = [prompt(i, n) for i, n in enumerate(lengths)]
    pchunk = 8 if mode == "inscan" else 0
    jsrv = JaxServer(jax_model(), jax_params(),
                     JaxServeConfig(chunk=4, slots=4, max_inflight=8, prefill_buckets=BUCKETS,
                                    prefill_chunk=pchunk))
    srv = Server(model, _cfg(mode, slots=4))
    jps = [jsrv.submit(JaxDecodeRequest(prompt=jnp.asarray(p, jnp.int32), max_new_tokens=8,
                                        sample=jax_sample(GREEDY), seed=i))
           for i, p in enumerate(prompts)]
    ps = [srv.submit(_req(p, seed=i)) for i, p in enumerate(prompts)]
    assert jsrv.serve(drain_when_idle=True) == srv.serve(drain_when_idle=True) == 0
    jsrv.close()
    srv.close()
    for i, (jp, p) in enumerate(zip(jps, ps)):
        assert p.result.status == jp.result.status == "ok"
        np.testing.assert_array_equal(p.result.tokens, np.asarray(jp.result.tokens),
                                      err_msg=f"{mode} request {i}")
    assert srv.stats == jsrv.stats
    assert _edges(srv.health) == _edges(jsrv.health)


# -- the health machine (test_serving.py :76, :97) --------------------------------


def test_health_machine_legal_path_and_illegal_edges():
    from orion_tpu.serving.health import HTTP_STATUS as JAX_HTTP_STATUS
    from orion_tpu_torch.serving.health import HTTP_STATUS

    h = HealthMachine()
    assert h.state is Health.STARTING and h.accepting
    assert h.to(Health.SERVING, "ready")
    assert not h.to(Health.SERVING)  # idempotent, not an error
    assert h.to(Health.DEGRADED, "ladder engaged")
    assert h.accepting, "DEGRADED still serves"
    assert h.to(Health.SERVING, "recovered")
    assert h.to(Health.DRAINING, "sigterm")
    assert not h.accepting
    with pytest.raises(InvalidTransition):
        h.to(Health.SERVING, "no way back from draining")
    assert h.to(Health.DEAD, "drained")
    with pytest.raises(InvalidTransition):
        h.to(Health.SERVING, "dead is dead")
    snap = h.snapshot()
    assert snap["state"] == "dead" and len(snap["transitions"]) == 6 and snap["dropped"] == 0
    assert {k.value: v for k, v in HTTP_STATUS.items()} == {
        k.value: v for k, v in JAX_HTTP_STATUS.items()}


def test_health_history_bounded_on_flapping_replica():
    h = HealthMachine(history_limit=8)
    h.to(Health.SERVING, "ready")
    for i in range(50):
        h.to(Health.DEGRADED, f"flap {i}")
        h.to(Health.SERVING, f"recover {i}")
    snap = h.snapshot()
    assert len(h.history) == len(snap["transitions"]) == 8
    assert snap["dropped"] == 102 - 8
    assert snap["transitions"][-1]["reason"] == "recover 49" and snap["state"] == "serving"
    assert h.restate("sharper why") and h.reason == "sharper why" and not h.restate("sharper why")


# -- the server's contracts, bitwise inside the port --------------------------------


@pytest.mark.parametrize("mode", ["host", "inscan"])
@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_served_requests_bitwise_solo(model, mode, sample):
    """slots + 2 requests through the Server: every one bitwise its one-row
    ``generate`` at its seed, with late admission into freed slots."""
    prompts = [prompt(200 + i, n) for i, n in enumerate([3, 8, 9, 13, 5, 17])]
    srv = Server(model, _cfg(mode, slots=4))
    ps = [srv.submit(_req(p, sample=sample, seed=500 + i)) for i, p in enumerate(prompts)]
    assert srv.serve(drain_when_idle=True) == 0
    for i, (p, pend) in enumerate(zip(prompts, ps)):
        assert pend.result.status == "ok", i
        np.testing.assert_array_equal(pend.result.tokens, _solo(model, p, 8, sample, 500 + i),
                                      err_msg=f"{mode} request {i}")
    assert srv.stats["ok"] == 6 and srv.stats["admitted"] == 6
    srv.close()


def test_deadline_anchored_at_admission_counts_queue_wait(model):
    now = [0.0]
    srv = Server(model, _cfg(max_inflight=4), clock=lambda: now[0])
    p = srv.submit(_req(prompt(0, 5), deadline_ms=500.0))
    now[0] = 1.0  # the queue ate the whole budget
    srv.serve(drain_when_idle=True)
    assert p.result.status == "deadline" and p.result.new_tokens == 0
    assert srv.stats["deadline"] == 1
    srv.close()


def test_default_deadline_evicts_at_a_chunk_boundary(model):
    """ServeConfig.deadline_ms applies to a request without its own: a fake
    clock a second a boundary against 2.5 s evicts it with two chunks, a
    bitwise prefix of its solo tokens."""
    now = [0.0]
    srv = Server(model, _cfg(deadline_ms=2500.0), clock=lambda: now[0])
    real_step = srv.engine.step

    def ticking_step():
        out = real_step()
        now[0] += 1.0
        return out

    srv.engine.step = ticking_step
    p0 = prompt(0, 5)
    pend = srv.submit(_req(p0, new=16))
    srv.serve(drain_when_idle=True)
    assert pend.result.status == "deadline" and pend.result.new_tokens == 12
    np.testing.assert_array_equal(pend.result.tokens, _solo(model, p0, 16, GREEDY, 0)[:, :12])
    srv.close()


def test_sigterm_mid_request_drains_and_exits_zero(model):
    """A real SIGTERM at engine boundary 1: the in-flight and the queued
    request complete bitwise, new submits are rejected, serve() returns 0
    and health goes SERVING -> DRAINING -> DEAD."""
    p0 = prompt(0, 5)
    ref = _solo(model, p0, 8, GREEDY, 0)
    srv = Server(model, _cfg(slots=1, max_inflight=4))
    p1, p2 = srv.submit(_req(p0)), srv.submit(_req(p0))
    plan = inject.FaultPlan().preempt_at_chunk(1)
    with inject.inject(plan):
        rc = srv.serve()
    assert rc == 0 and plan.delivered == ["serve.chunk@1"]
    assert srv.health.state is Health.DEAD
    for p in (p1, p2):
        assert p.result.status == "ok"
        np.testing.assert_array_equal(p.result.tokens, ref)
    with pytest.raises(RejectedError):
        srv.submit(_req(p0))
    assert srv.stats["rejected"] == 1 and srv.stats["ok"] == 2
    edges = _edges(srv.health)
    assert ("serving", "draining") in edges and ("draining", "dead") in edges


def test_sigterm_mid_batch_drains_all_slots_and_exits_zero(model):
    """test_batching.py :370: a full batch of 2 and one queued request; SIGTERM
    at boundary 1: all three complete bitwise."""
    prompts = _prompts(3)
    srv = Server(model, _cfg(slots=2, max_inflight=4))
    ps = [srv.submit(_req(p, seed=500 + i)) for i, p in enumerate(prompts)]
    plan = inject.FaultPlan().preempt_at_chunk(1)
    with inject.inject(plan):
        assert srv.serve() == 0
    assert plan.delivered == ["serve.chunk@1"] and srv.health.state is Health.DEAD
    for i, (p, pend) in enumerate(zip(prompts, ps)):
        assert pend.result.status == "ok", i
        np.testing.assert_array_equal(pend.result.tokens, _solo(model, p, 8, GREEDY, 500 + i))
    with pytest.raises(RejectedError):
        srv.submit(_req(prompts[0]))


def test_overload_sheds_then_admitted_work_drains(model):
    p0 = prompt(0, 5)
    srv = Server(model, _cfg(max_inflight=1))
    p1 = srv.submit(_req(p0))
    with pytest.raises(OverloadError, match="admission queue full"):
        srv.submit(_req(p0))
    assert srv.stats["shed"] == 1
    assert srv.serve(drain_when_idle=True) == 0
    np.testing.assert_array_equal(p1.result.tokens, _solo(model, p0, 8, GREEDY, 0))
    assert srv.health.state is Health.SERVING  # idle drain: the CLI's waves resubmit
    srv.close()
    assert srv.health.state is Health.DEAD


def test_ladder_degrades_health_and_clean_request_recovers(model):
    p0 = prompt(0, 5)
    ref = _solo(model, p0, 8, GREEDY, 0)
    srv = Server(model, _cfg(max_inflight=4))
    pend = srv.submit(_req(p0))
    with inject.inject(inject.FaultPlan().poison_decode_state_at(0)):
        srv.serve(drain_when_idle=True)
    assert srv.health.state is Health.DEGRADED and srv.stats["rewinds"] == 1
    np.testing.assert_array_equal(pend.result.tokens, ref)
    srv.submit(_req(p0))
    srv.serve(drain_when_idle=True)
    assert srv.health.state is Health.SERVING, "a clean request recovers"
    srv.close()


@pytest.mark.parametrize("times,rungs,status", [(1, (1, 0), "ok"), (2, (1, 1), "ok"),
                                                (-1, None, "failed")],
                         ids=["rewind", "reprefill", "exhausted"])
def test_ladder_rungs_through_the_server(model, times, rungs, status):
    """Slot 1 poisoned at its chunk 1: the rung's counters ride the stats and
    the ladder_rungs cells; slot 0 streams on bitwise; an exhausted ladder
    fails its request only."""
    prompts = _prompts(2)
    refs = [_solo(model, p, 8, GREEDY, 500 + i) for i, p in enumerate(prompts)]
    srv = Server(model, _cfg())
    ps = [srv.submit(_req(p, seed=500 + i)) for i, p in enumerate(prompts)]
    with inject.inject(inject.FaultPlan().poison_decode_slot_at(1, chunk=1, times=times)):
        srv.serve(drain_when_idle=True)
    np.testing.assert_array_equal(ps[0].result.tokens, refs[0])
    r = ps[1].result
    assert r.status == status and srv.stats[status] >= 1
    if rungs:
        assert (r.rewinds, r.reprefills) == rungs
        np.testing.assert_array_equal(r.tokens, refs[1])
    else:
        np.testing.assert_array_equal(r.tokens, refs[1][:, :4])
    cells = {dict(c["labels"]).get("rung"): c["value"]
             for c in srv.metrics.snapshot()["counters"] if c["name"] == "ladder_rungs"}
    assert cells["rewind"] == 1
    assert ("serving", "degraded") in _edges(srv.health)
    srv.close()


def test_request_isolation_bad_request_never_kills_server(model):
    """Requests that raise at admission (past max_seq_len, a batch of rows,
    a session id without the store) are error RESULTS; the good one
    completes bitwise."""
    p0 = prompt(0, 5)
    srv = Server(model, _cfg(max_inflight=8))
    bad = srv.submit(_req(p0, new=CFG.max_seq_len * 2))
    rows = srv.submit(_req(np.ones((2, 4), np.int64)))
    sess = srv.submit(_req(p0, session_id="conv"))
    good = srv.submit(_req(p0))
    srv.serve(drain_when_idle=True)
    assert isinstance(bad.error, ValueError) and bad.result is None
    assert isinstance(rows.error, ValueError)
    with pytest.raises(ValueError, match="A8 step 3"):
        sess.wait(timeout=0)
    np.testing.assert_array_equal(good.result.tokens, _solo(model, p0, 8, GREEDY, 0))
    assert srv.stats["failed"] == 3 and srv.stats["ok"] == 1
    srv.close()


def test_watchdog_stall_degrades_health(model):
    srv = Server(model, _cfg(stall_timeout=60.0))
    srv.health.to(Health.SERVING, "test")
    srv._on_stall("stall detected (attempt 1): no heartbeat")
    assert srv.health.state is Health.DEGRADED and srv.stats["stalls"] == 1


def test_abnormal_loop_exit_completes_resident_pendings(model, monkeypatch):
    """test_batching.py :530: the loop dies mid-chunk; the resident Pending
    completes 'failed' with its first chunk (bitwise), the queued one is
    rejected; neither hangs."""
    prompts = _prompts(2)
    srv = Server(model, _cfg(slots=1, max_inflight=2))
    p1 = srv.submit(_req(prompts[0]))
    p2 = srv.submit(_req(prompts[1], seed=1))
    calls = {"n": 0}
    real_step = srv.engine.step

    def exploding_step():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated device failure")
        return real_step()

    monkeypatch.setattr(srv.engine, "step", exploding_step)
    with pytest.raises(RuntimeError, match="simulated device failure"):
        srv.serve(drain_when_idle=True)
    assert p1.done.is_set() and p1.result.status == "failed" and p1.result.new_tokens == 4
    np.testing.assert_array_equal(p1.result.tokens,
                                  _solo(model, prompts[0], 8, GREEDY, 0)[:, :4])
    assert p2.done.is_set()
    with pytest.raises(RejectedError):
        p2.wait(timeout=0)


def test_server_occupancy_gauges(model):
    """test_batching.py :564."""
    srv = Server(model, _cfg(slots=2, max_inflight=4))
    for i, p in enumerate(_prompts(3)):
        srv.submit(_req(p, seed=i))
    srv.serve(drain_when_idle=True)
    assert srv.stats["chunks"] >= 4
    assert 0.0 < srv.occupancy_lifetime() <= 1.0 and srv.occupancy() == 0.0
    snap = srv.snapshot()
    assert snap["slots"]["slots"] == 2 and snap["slots"]["active"] == 0
    assert snap["stats"]["ok"] == 3 and snap["occupancy"] == srv.occupancy_lifetime()
    assert snap["queued"] == 0 and snap["state"] == "serving"
    srv.close()


def test_feeder_threads_submit_while_serving(model):
    """4 feeder threads submit 3 requests each while serve() runs on this
    thread (the switch interval shortened): every Pending completes exactly
    once, bitwise solo; the drain then rejects a late submit."""
    prompts = [prompt(300 + i, 3 + i % 6) for i in range(12)]
    refs = [_solo(model, p, 8, GREEDY, 700 + i) for i, p in enumerate(prompts)]
    srv = Server(model, _cfg(slots=3, max_inflight=12))
    guard = PreemptionGuard()  # not entered: request_stop is the drain
    pendings, fired = {}, collections.Counter()
    lock = threading.Lock()

    def feed(k):
        for i in range(k, 12, 4):
            p = srv.submit(_req(prompts[i], seed=700 + i))
            p.on_done = lambda pend, i=i: fired.update([i])
            with lock:
                pendings[i] = p
            time.sleep(0.002)

    def stopper(feeders):
        for t in feeders:
            t.join(timeout=60)
        guard.request_stop()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        feeders = [threading.Thread(target=feed, args=(k,)) for k in range(4)]
        stop = threading.Thread(target=stopper, args=(feeders,))
        for t in (*feeders, stop):
            t.start()
        assert srv.serve(guard=guard) == 0
        stop.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not stop.is_alive() and not any(t.is_alive() for t in feeders)
    assert sorted(pendings) == list(range(12))
    for i, p in pendings.items():
        assert p.done.is_set() and p.result.status == "ok", i
        np.testing.assert_array_equal(p.result.tokens, refs[i], err_msg=f"request {i}")
    time.sleep(0.01)  # on_done runs right after done.set()
    assert fired == collections.Counter(range(12)), "each Pending completes exactly once"
    assert srv.health.state is Health.DEAD
    with pytest.raises(RejectedError):
        srv.submit(_req(prompts[0]))


class _Reads(TorchDispatchMode):
    """Counts every aten op, and the ones that read a device value on the
    host: ``_local_scalar_dense`` (``.item()``, ``int()`` / ``bool()`` of a
    tensor) and copies onto the CPU from another device."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        self.ops[name] += 1
        if name == "aten._local_scalar_dense":
            self.reads += 1
        elif name in ("aten._to_copy", "aten.copy_"):
            src = args[1] if name == "aten.copy_" else args[0]
            dst = args[0] if name == "aten.copy_" else out
            if (isinstance(src, torch.Tensor) and src.device.type != "cpu"
                    and dst.device.type == "cpu"):
                self.reads += 1
        return out


def test_server_adds_no_host_read_beyond_the_engine(model):
    """The Server around a SlotEngine, against the bare engine driven with the
    same admission schedule: the same device reads and the same aten ops
    (the Server's telemetry is host bookkeeping only)."""
    prompts = _prompts(3)
    reqs = [_req(p.astype(np.int64), seed=i) for i, p in enumerate(prompts)]
    srv = Server(model, _cfg(slots=2, max_inflight=4,
                             stall_timeout=60.0))
    for r in reqs:
        srv.submit(r)
    with _Reads() as served:
        srv.serve(drain_when_idle=True)
    srv.close()
    eng = SlotEngine(model, slots=2, chunk=4, prefill_buckets=(8, 16, 32), device="cpu")
    pending = list(reqs)
    with _Reads() as bare:
        while pending or eng.busy:
            while pending and eng.has_free_slot:
                eng.admit(pending.pop(0))
            eng.step()
    assert served.reads == bare.reads
    assert served.ops == bare.ops
    assert served.ops["aten.linear"] > 0


# -- refusals -------------------------------------------------------------------------


@pytest.mark.parametrize("field", sorted(server_mod._NOT_PORTED))
def test_unported_serve_config_fields_raise(model, field):
    default = {f.name: f.default for f in dataclasses.fields(ServeConfig)}[field]
    value = "x" if default is None else (not default if isinstance(default, bool)
                                         else default + 2)
    with pytest.raises(NotImplementedError, match=server_mod._NOT_PORTED[field]):
        Server(model, dataclasses.replace(ServeConfig(), **{field: value}))
    if field == "tp":
        Server(model, dataclasses.replace(_cfg(), tp=1))  # 1 means unsharded


def test_more_slots_than_decode_rows_is_refused(model):
    """C1 above 64 slots: a decode step pads its products' rows to
    DECODE_ROWS and runs them at the batch's own row count above it, so a
    row's products then follow its company (on the card cuBLAS picks its
    kernel by that count). Shown here on the products' shapes at 4 slots
    and at 65; the engine, the Server and the CLI refuse 65 slots."""
    shapes = {}

    class Rows(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func.overloadpacket) in ("aten.linear", "aten.matmul") and args[0].dim() == 2:
                shapes.setdefault(n, set()).add(args[0].shape[0])
            return func(*args, **(kwargs or {}))

    for n in (4, DECODE_ROWS + 1):
        states = transformer.init_decode_state(CFG, n, "cpu")
        with torch.inference_mode(), Rows():
            model.decode_step(torch.zeros(n, dtype=torch.long), states, torch.zeros(n, dtype=torch.long))
    assert shapes[4] == {DECODE_ROWS} and shapes[DECODE_ROWS + 1] == {DECODE_ROWS + 1}
    with pytest.raises(ValueError, match="C1"):
        SlotEngine(model, slots=DECODE_ROWS + 1, chunk=4, device="cpu")
    with pytest.raises(ValueError, match="C1"):
        Server(model, _cfg(slots=DECODE_ROWS + 1))
    with pytest.raises(ValueError, match="C1"):
        cli_main(["--config", "tiny", "--device", "cpu", "--slots", str(DECODE_ROWS + 1),
                  "--prompts-file", os.devnull])
    SlotEngine(model, slots=DECODE_ROWS, chunk=4, device="cpu")  # the limit itself serves


@pytest.mark.parametrize("flag,typ,default,item", _NOT_PORTED_FLAGS,
                         ids=[f[0] for f in _NOT_PORTED_FLAGS])
def test_unported_cli_flags_raise(flag, typ, default, item):
    value = "x" if typ is str else str(typ(default) + 2)
    with pytest.raises(NotImplementedError, match=item):
        cli_main(["--device", "cpu", flag, value, "--prompts-file", os.devnull])


def test_server_refuses_a_device_other_than_the_model(model):
    with pytest.raises(ValueError, match="the model is on"):
        Server(model, _cfg(), device="meta")


# -- hardened loaders (test_serving.py :313, :361) ------------------------------------


@pytest.fixture(scope="module")
def served_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve") / "ck")
    m = TransformerLM(dataclasses.replace(CFG, name="serve_ck"), device="cpu")
    ck = Checkpointer(d, save_every=2)
    for step in (2, 4):
        ck.maybe_save(step, {"params": m.state_dict()})
    return d


def test_load_params_retries_transient_io(served_ckpt):
    plan = inject.FaultPlan().fail_io("serve.ckpt_load", times=2)
    with inject.inject(plan), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        params, step = load_params(served_ckpt, retry=FAST_RETRY)
    assert step == 4 and "embed.weight" in params
    assert sum("retrying" in str(x.message) for x in w) == 2
    assert plan.delivered == ["serve.ckpt_load@4"] * 2


def test_tokenizer_load_retries_transient_io():
    plan = inject.FaultPlan().fail_io("serve.tokenizer_io", times=2)
    with inject.inject(plan), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tok = load_tokenizer(None, retry=FAST_RETRY)
    assert tok.decode(tok.encode("ab")) == "ab"
    assert sum("retrying" in str(x.message) for x in w) == 2
    assert plan.delivered == ["serve.tokenizer_io@None"] * 2


# -- the CLI (test_serving.py :376) ---------------------------------------------------


def test_serving_cli_smoke(tmp_path, capsys):
    """Two prompts through waves of one (--max-inflight 1): one stdout line
    each, in order, the greedy tokens of a one-row generate on the CLI's
    seeded weights; stats and occupancy on stderr."""
    pf = tmp_path / "prompts.txt"
    pf.write_text("ab\ncd\n")
    rc = cli_main(["--config", "tiny", "--device", "cpu", "--prompts-file", str(pf),
                   "--max-new-tokens", "4", "--chunk", "2", "--temperature", "0",
                   "--max-inflight", "1", "--deadline-ms", "60000",
                   "--metrics-path", str(tmp_path / "m.prom")])
    assert rc == 0
    cap = capsys.readouterr()
    out = cap.out.strip().splitlines()
    assert len(out) == 2 and out[0].startswith("ab") and out[1].startswith("cd")
    from orion_tpu_torch.models.configs import TINY
    from orion_tpu_torch.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    m = gen.cast_params_for_inference(TransformerLM(TINY, device="cpu"))
    for i, line in enumerate(("ab", "cd")):
        ids = gen.generate(m, torch.tensor([tok.encode(line)]), 4, GREEDY, i)[0].tolist()
        assert out[i] == line + tok.decode(ids)
    assert "stats: {'admitted': 2" in cap.err and "slot occupancy:" in cap.err
    assert "ok 2" in (tmp_path / "m.prom").read_text()


def test_cli_sigterm_mid_run_exits_zero(tmp_path):
    """A real SIGTERM to the CLI process after its first boundary (a metrics
    dump, one a second, shows a chunk): it drains, finishing the queued
    prompt too, and exits 0, not 143, with its stats line."""
    mp = tmp_path / "m.prom"
    (tmp_path / "p.txt").write_text("p0\np1\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "orion_tpu_torch.serving", "--config", "tiny", "--device", "cpu",
         "--max-new-tokens", "300", "--chunk", "2", "--slots", "1", "--temperature", "0",
         "--metrics-path", str(mp), "--metrics-interval-s", "0.01", "--prompts-file", "p.txt"],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(tmp_path), env=env)
    deadline = time.monotonic() + 120
    chunks = 0
    while chunks < 1 and time.monotonic() < deadline and proc.poll() is None:
        time.sleep(0.05)
        try:
            snap = json.loads((tmp_path / "m.prom.json").read_text())
        except (OSError, ValueError):
            continue
        chunks = sum(c["value"] for c in snap["counters"] if c["name"] == "chunks")
    if proc.poll() is not None or chunks < 1:
        proc.kill()
        out, err = proc.communicate(timeout=60)
        pytest.fail(f"the CLI ended or stalled before its first boundary: {err}")
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    assert "stats:" in err and "'ok': 2" in err, "the drain completes the queued prompt too"
    assert out.startswith("p0") and "\np1" in out  # generated bytes may hold newlines
