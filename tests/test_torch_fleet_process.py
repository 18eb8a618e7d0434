"""The port's fleet over child processes (``ProcessReplica``, two children
at a time, each asked for the CPU explicitly): the reference's
``tests/test_fleet.py`` :746-852 bitwise inside the port, each conversation
held against the port's one-row ``generate`` over the model a child builds
(``build_model`` in this process): a drain rerouted, a ``fleet.control_io``
fault failed over, a SIGKILLed child respawned and its committed
conversation continued; ``python -m orion_tpu_torch.fleet`` over two
children printing the ``--local`` fleet's lines; and a child asked for the
card on a machine without one fails at start-up, so the fleet does not
serve (no CPU fallback).

Tolerance: tokens bitwise (greedy, fp32).
"""

import numpy as np
import pytest
import torch

from orion_tpu_torch import generate as gen
from orion_tpu_torch.fleet import ProcessReplica, ReplicaSpec, Supervisor
from orion_tpu_torch.fleet.replica import ReplicaGone, build_model
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.resilience.retry import RetryPolicy
from orion_tpu_torch.serving import DecodeRequest
from torch_serving_common import CFG, GREEDY

torch.set_num_threads(2)


def _prompt(i, ln=5):
    return np.random.default_rng(2000 + i).integers(0, CFG.vocab_size, (1, ln))


def _ref(model, prompt, n_new, sample, seed):
    return gen.generate(model, torch.from_numpy(prompt), n_new, sample, seed).numpy()


def _req(prompt, want, sample, seed, sid=None):
    return DecodeRequest(prompt=prompt, max_new_tokens=want, sample=sample, seed=seed,
                         session_id=sid)


def _cont(want, sample, sid):
    return _req(np.zeros((1, 0), np.int64), want, sample, 0, sid)


def _wait(pending, timeout=120.0):
    assert pending.done.wait(timeout=timeout), "request never resolved"
    return pending



_PROC_OVERRIDES = {"vocab_size": 64, "d_model": 32, "n_layers": 3, "n_heads": 2,
                   "layer_types": ["linear", "softmax", "swa"], "window": 4, "max_seq_len": 96}


def _proc_spec(tmp_path, faults=None, **serve_kw):
    serve = {"chunk": 4, "slots": 2, "max_inflight": 8, "session_dir": str(tmp_path / "sessions")}
    serve.update(serve_kw)
    return ReplicaSpec(config="tiny", overrides=_PROC_OVERRIDES, serve=serve, faults=faults,
                       device="cpu", compute_cpus=[0, 1])


def _proc_ref(spec, prompt, n_new, sample, seed):
    """The in-parent reference over the model a child builds."""
    model, _ = build_model(spec)
    return _ref(model, prompt, n_new, sample, seed)


def test_process_fleet_drain_reroute_bitwise(tmp_path):
    """Replica 0 (a child process) delivers itself a SIGTERM mid-stream (its
    spec's fault plan), its session suspends to the shared store as it
    drains to exit 0, the supervisor respawns it, and the continuation is
    rerouted to the other child: bitwise one uninterrupted run."""
    want, prompt = 24, _prompt(10)
    clean = _proc_spec(tmp_path)
    faulted = _proc_spec(tmp_path, faults=[{"kind": "preempt_at_chunk", "args": [2]}])
    ref = _proc_ref(clean, prompt, want, GREEDY, seed=500)
    spawned = [0]

    def factory(name):
        spawned[0] += 1
        return ProcessReplica(faulted if spawned[0] == 1 else clean, name=name).start()

    sup = Supervisor(factory, 2, heartbeat_timeout=10.0).start()
    try:
        p1 = _wait(sup.router.submit(_req(prompt, want, GREEDY, 500, "conv")), timeout=300.0)
        assert p1.result.status == "suspended" and 0 < p1.result.new_tokens < want
        victim = sup.replicas[0]
        assert victim.join(timeout=60.0) and victim.exit_rc == 0
        p2 = _wait(sup.router.submit(_cont(want - p1.result.new_tokens, GREEDY, "conv")),
                   timeout=300.0)
        assert p2.result.status == "ok" and p2.replica != victim.name, "continuation rerouted"
        np.testing.assert_array_equal(np.concatenate([p1.result.tokens, p2.result.tokens], 1), ref)
        for _ in range(10):  # heal: the exited replica is respawned
            sup.tick()
            if all(r.alive for r in sup.replicas):
                break
        assert victim not in sup.replicas and all(r.alive for r in sup.replicas)
    finally:
        sup.drain_all(timeout=60.0)


def test_process_fleet_kill_control_io_and_heartbeat(tmp_path):
    """(1) status() reads the atomic snapshot over the wire; (2) an injected
    fleet.control_io fault breaks the first candidate's channel mid-submit
    and the router fails over; (3) SIGKILL of a child is seen by the
    heartbeat, the supervisor respawns it, and the conversation committed
    before the kill continues bitwise."""
    clean = _proc_spec(tmp_path)
    prompt = _prompt(21)
    ref = _proc_ref(clean, prompt, 16, GREEDY, seed=7)

    def factory(name):
        return ProcessReplica(clean, name=name).start()

    sup = Supervisor(factory, 2, heartbeat_timeout=10.0, miss_limit=1).start()
    try:
        st = sup.replicas[0].status(timeout=30.0)
        assert st is not None and st["state"] == "serving"
        assert {"prefilling", "decoding"} <= set(st["slots"]) and "slo" in st
        p1 = _wait(sup.router.submit(_req(prompt, 8, GREEDY, 7, "conv")), timeout=300.0)
        assert p1.result.status == "ok"
        (served,) = [r for r in sup.replicas if r.name == p1.replica]
        (other,) = [r for r in sup.replicas if r is not served]
        plan = inject.FaultPlan().fail_io("fleet.control_io", times=1)
        with inject.inject(plan):
            p = _wait(sup.router.submit(_req(_prompt(22), 4, GREEDY, 1)), timeout=300.0)
        assert plan.delivered and p.result.status == "ok"
        assert sup.router.stats["failovers"] >= 1
        served.kill()
        assert served.join(timeout=30.0)
        assert served.status(timeout=5.0) is None, "no heartbeat from a dead child"
        p2 = _wait(sup.router.submit(_cont(8, GREEDY, "conv")), timeout=300.0)
        assert p2.result.status == "ok" and other.alive
        np.testing.assert_array_equal(np.concatenate([p1.result.tokens, p2.result.tokens], 1), ref)
        for _ in range(10):
            sup.tick()
            if all(r.alive for r in sup.replicas):
                break
        assert served not in sup.replicas and all(r.alive for r in sup.replicas)
    finally:
        sup.drain_all(timeout=60.0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_child_without_a_card_fails_at_startup(tmp_path):
    """A replica asked for the card (the default) on a machine without one
    fails before it reports ready, and the fleet does not start: no CPU
    fallback."""
    spec = ReplicaSpec(config="tiny", overrides=_PROC_OVERRIDES, serve={"chunk": 4, "slots": 2})
    assert spec.device == "cuda"
    made = []

    def factory(name):
        made.append(ProcessReplica(spec, name=name).start())
        return made[-1]

    with pytest.raises(ReplicaGone, match="died during startup"):
        Supervisor(factory, 1, spawn_retry=RetryPolicy(attempts=1)).start()
    (r,) = made
    assert r.join(timeout=30.0) and r.exit_rc not in (0, None) and not r.alive


def test_fleet_cli_with_process_replicas_matches_local(tmp_path, capsys):
    """``python -m orion_tpu_torch.fleet`` over two child processes prints
    the lines of the same fleet over threads (``--local``), bitwise, and
    exits 0."""
    from orion_tpu_torch.fleet.__main__ import main

    pf = tmp_path / "prompts.txt"
    pf.write_text("ab\ncd\nef\n")
    args = ["--replicas", "2", "--config", "tiny", "--set", "d_model=32", "--set", "n_layers=1",
            "--set", "n_heads=2", "--set", "max_seq_len=64", "--prompts-file", str(pf),
            "--max-new-tokens", "6", "--chunk", "2", "--slots", "2", "--prefill-chunk", "0",
            "--temperature", "0", "--device", "cpu"]
    assert main(args + ["--local"]) == 0
    want = capsys.readouterr().out
    assert main(args + ["--session-dir", str(tmp_path / "s")]) == 0
    out = capsys.readouterr()
    assert out.out == want and len(want.splitlines()) == 3
    assert "replica-1.g2: spawned" in out.err
