"""Supervised replica handles: one ``serving.Server`` behind one wire. The
port's counterpart of ``orion_tpu/fleet/replica.py``.

A *replica* is a whole serving stack -- SlotEngine, health machine, durable
sessions, SIGTERM drain -- addressed through a small uniform interface
(:class:`ReplicaHandle`): ``submit`` a request, poll ``status`` (the
server's atomic health + occupancy snapshot), ``drain`` it gracefully,
``kill`` it, ``join`` its exit. The router and the supervisor speak only
this interface, so the same fleet logic runs over both transports:

- :class:`ProcessReplica` -- the production shape: the server runs in a
  child OS process (its own interpreter, CUDA context and crash domain)
  started as ``python -m orion_tpu_torch.fleet._child``, a fresh
  interpreter, never a fork of a process that has initialised CUDA. The
  parent talks to it over a line-delimited JSON control channel on the
  child's stdin / stdout: ops down (``status`` / ``submit`` / ``shutdown``),
  replies and asynchronous ``result`` events up. SIGTERM to the child is the
  drain (the server's PreemptionGuard suspends resident sessions to the
  shared store and exits 0); SIGKILL is the crash the session store's
  generation commit protects against. EOF on stdin (the parent died) drains
  too: a fleet never leaks orphan decoders.
- :class:`LocalReplica` -- the same server driven by a thread of this
  process behind the same interface (tests, the CLI's ``--local``).
  ``drain()`` flips a stop flag the serve loop treats as SIGTERM; ``kill()``
  makes the loop raise at its next boundary check (no suspension, pendings
  fail, the last committed session generation on disk stays the
  conversation's truth).

Every wait on the control path carries a timeout: a dead child surfaces as a
missed heartbeat, never as a parent thread parked on a pipe.

Where a replica runs is explicit: :class:`ReplicaSpec` ``device`` (the card
unless it says ``"cpu"``). A child asked for the card on a machine without
one fails before it reports ready, and the supervisor sees that failure;
nothing falls back to the CPU.

Bitwise note: replicas build their weights from the same seeded generator
(or the same checkpoint), and the decode path is deterministic per request
seed and bitwise independent of a row's company (C1's fix), so WHICH replica
serves a request never changes its tokens, and a conversation suspended on
one replica resumes bitwise on another.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from orion_tpu_torch.obs import flight
from orion_tpu_torch.resilience.inject import fire
from orion_tpu_torch.serving.session import DecodeRequest, DecodeResult

# how long a parent waits for a submit's admission ack before declaring the
# control channel dead (results arrive asynchronously)
ACK_TIMEOUT_S = 30.0


class ReplicaGone(RuntimeError):
    """The replica's process / loop is dead or its control channel broke; the
    caller (router) re-dispatches elsewhere and the supervisor respawns."""


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """Everything a child process needs to become a replica, as one JSON-able
    value: the model (config name, field overrides, and a seeded init or a
    checkpoint), the ServeConfig knobs and the device. Every replica of a
    fleet gets the SAME spec: identical weights make placement invisible in
    the tokens. Quantized serving and the prefix cache ride the ``serve``
    dict (``qmode``, ``prefix_dir``, ``params_id``).

    ``faults``: chaos only -- fault-plan entries armed INSIDE the child (e.g.
    ``[{"kind": "preempt_at_chunk", "args": [2]}]``), so a test poisons one
    replica of a live fleet without the plan reaching its siblings.

    ``compute_cpus``: pin the child process to these cores
    (``os.sched_setaffinity``; None = every core).

    ``tp``: the replica's tensor-parallel footprint; anything above 1 is
    refused by the Server (ROADMAP.md A12).

    ``device``: where the child's model and engine live, ``"cuda"`` (the
    card, the default) or ``"cpu"``."""

    config: str = "tiny"
    overrides: Optional[Dict[str, Any]] = None  # ModelConfig field -> value
    init_seed: int = 0
    ckpt_dir: Optional[str] = None
    serve: Optional[Dict[str, Any]] = None  # ServeConfig kwargs
    faults: Optional[List[Dict[str, Any]]] = None
    compute_cpus: Optional[List[int]] = None
    tp: int = 0
    device: str = "cuda"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(text: str) -> "ReplicaSpec":
        return ReplicaSpec(**json.loads(text))


def build_model(spec: ReplicaSpec):
    """(model, params_id) for a replica: the named config with the field
    overrides applied, on ``spec.device``, weights from the checkpoint when
    given, else drawn from a ``torch.Generator`` seeded ``spec.init_seed``
    (identical in every process that runs this with the same spec). A bf16
    config's dense weights are rounded to the compute dtype once unless the
    spec's serve dict quantizes (as the serving CLI does).

    ``params_id`` is the weights' provenance the stores key on, derived as
    the JAX package derives it: config + overrides fingerprint + (checkpoint
    dir and the step the load resolved to, or the init seed)."""
    import torch

    from orion_tpu_torch.generate import cast_params_for_inference, load_model
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.models.transformer import TransformerLM
    from orion_tpu_torch.serving.prefix_store import overrides_fingerprint
    from orion_tpu_torch.utils.device import resolve_device

    device = resolve_device(spec.device)
    cfg = get_config(spec.config)
    if spec.overrides:
        from orion_tpu_torch.utils.config import apply_overrides

        cfg = apply_overrides(cfg, {
            # JSON has no tuples; ModelConfig fields are hashable
            k: (tuple(v) if isinstance(v, list) else v) for k, v in spec.overrides.items()})
    ov = overrides_fingerprint(spec.overrides)
    if spec.ckpt_dir:
        model, step = load_model(cfg, spec.ckpt_dir, device)
        pid = f"{spec.config}:ov={ov}:ckpt={spec.ckpt_dir}:step={step}"
    else:
        model = TransformerLM(cfg, device=device,
                              generator=torch.Generator(device=device).manual_seed(spec.init_seed))
        pid = f"{spec.config}:ov={ov}:seed={spec.init_seed}"
    if (spec.serve or {}).get("qmode", "off") in ("off", "", None):
        model = cast_params_for_inference(model)
    return model, pid


def serve_config(spec: ReplicaSpec, params_id: Optional[str] = None):
    """ServeConfig from the spec; ``params_id`` (from :func:`build_model`)
    fills the stores' identity unless the spec pinned one, and ``spec.tp``
    is stamped onto the config (the footprint is the replica's)."""
    from orion_tpu_torch.serving.server import ServeConfig

    cfg = ServeConfig(**(spec.serve or {}))
    if params_id and not cfg.params_id:
        cfg = dataclasses.replace(cfg, params_id=params_id)
    if spec.tp and spec.tp > 1:
        cfg = dataclasses.replace(cfg, tp=int(spec.tp))
    return cfg


# -- wire helpers ---------------------------------------------------------------


_ERROR_TYPES: Dict[str, type] = {}


def _error_types() -> Dict[str, type]:
    """Exception classes a result event may name; resolved lazily so the wire
    layer doesn't import the serving stack at module load."""
    if not _ERROR_TYPES:
        from orion_tpu_torch.serving.server import OverloadError, RejectedError
        from orion_tpu_torch.serving.session_store import SessionIntegrityError

        _ERROR_TYPES.update({
            "OverloadError": OverloadError,
            "RejectedError": RejectedError,
            "SessionIntegrityError": SessionIntegrityError,
            "ValueError": ValueError,
            "TimeoutError": TimeoutError,
            # the parent's own reply from _fail_outstanding (a child never
            # sends it): must rebuild as ReplicaGone, or the router's
            # failover does not catch it
            "ReplicaGone": ReplicaGone,
        })
    return _ERROR_TYPES


def _rebuild_error(type_name: str, message: str) -> Exception:
    cls = _error_types().get(type_name)
    if cls is not None:
        return cls(message)
    return RuntimeError(f"{type_name}: {message}")


def _request_to_wire(request: DecodeRequest) -> Dict[str, Any]:
    prompt = np.asarray(request.prompt, np.int64)
    if prompt.ndim == 1:
        prompt = prompt[None]
    return {
        "prompt": prompt.tolist(),
        "max_new_tokens": int(request.max_new_tokens),
        "sample": dataclasses.asdict(request.sample),
        "seed": int(request.seed),
        "deadline_ms": float(request.deadline_ms),
        "session_id": request.session_id,
        "prefix_len": int(request.prefix_len),
    }


def _request_from_wire(msg: Dict[str, Any]) -> DecodeRequest:
    from orion_tpu_torch.generate import SampleConfig

    return DecodeRequest(
        prompt=np.asarray(msg["prompt"], np.int64),
        max_new_tokens=int(msg["max_new_tokens"]),
        sample=SampleConfig(**msg["sample"]),
        seed=int(msg.get("seed", 0)),
        deadline_ms=float(msg.get("deadline_ms", 0.0)),
        session_id=msg.get("session_id"),
        prefix_len=int(msg.get("prefix_len", 0)),
    )


def _result_to_wire(result: DecodeResult) -> Dict[str, Any]:
    return {
        "status": result.status,
        "tokens": np.asarray(result.tokens).tolist(),
        "new_tokens": int(result.new_tokens),
        "chunks": int(result.chunks),
        "rewinds": int(result.rewinds),
        "reprefills": int(result.reprefills),
    }


def _result_from_wire(msg: Dict[str, Any]) -> DecodeResult:
    return DecodeResult(
        tokens=np.asarray(msg["tokens"], np.int64).reshape(len(msg["tokens"]), -1),
        status=msg["status"],
        new_tokens=int(msg["new_tokens"]),
        chunks=int(msg["chunks"]),
        rewinds=int(msg.get("rewinds", 0)),
        reprefills=int(msg.get("reprefills", 0)),
    )


@dataclasses.dataclass
class FleetPending:
    """The parent-side handle of one request dispatched to a process replica,
    with the server Pending's contract: ``done`` fires exactly once with
    either ``result`` or ``error`` filled."""

    session_id: Optional[str]
    done: threading.Event
    submitted_at: float = 0.0
    done_at: float = 0.0
    result: Optional[DecodeResult] = None
    error: Optional[Exception] = None
    replica: str = ""
    # called exactly once right after ``done`` fires (result or error): the
    # router closes its root ``turn`` span here; host-only, exceptions
    # swallowed
    on_done: Optional[Callable[["FleetPending"], None]] = None

    def wait(self, timeout: Optional[float] = None) -> Optional[DecodeResult]:
        if not self.done.wait(timeout=timeout):
            return None
        if self.error is not None:
            raise self.error
        return self.result

    def _release(self) -> None:
        self.done.set()
        cb = self.on_done
        if cb is not None:
            try:
                cb(self)
            except Exception:
                pass  # telemetry must never break completion


# -- the uniform handle interface -------------------------------------------------


class ReplicaHandle:
    """What the router and the supervisor program against. Subclasses fill in
    the transport; the shared part is routing metadata."""

    name: str = "replica"

    @property
    def alive(self) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def inflight(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def health_state(self) -> str:  # pragma: no cover - abstract
        raise NotImplementedError

    def wait_ready(self, timeout: float) -> None:  # pragma: no cover
        raise NotImplementedError

    def submit(self, request: DecodeRequest):  # pragma: no cover
        raise NotImplementedError

    def status(self, timeout: float = 2.0) -> Optional[dict]:  # pragma: no cover
        raise NotImplementedError

    def drain(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def kill(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def join(self, timeout: float) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def routable(self) -> bool:
        """May the router place NEW work here? DEGRADED stays routable (the
        router deprioritizes it; shedding a limping but correct replica is
        the supervisor's call); DRAINING / DEAD never."""
        return self.alive and self.health_state() in ("starting", "serving", "degraded")

    def slo_penalty(self):
        """The latency-aware routing tie-break, applied after (health rank,
        inflight): ``(fast burn firing?, windowed p99 ms)`` from the replica's
        last status snapshot (its ``slo`` section). Stale-tolerant: the
        supervisor's heartbeat refreshes ``last_status`` once a tick. A
        replica with no SLO data yet sorts neutral ``(0, 0.0)``."""
        status = getattr(self, "last_status", None)
        slo = (status or {}).get("slo") or {}
        firing = 1 if slo.get("firing_fast") else 0
        p99 = slo.get("p99_ms")
        return (firing, p99 if p99 is not None else 0.0)


# -- process replica ----------------------------------------------------------------


class ProcessReplica(ReplicaHandle):
    """A serving.Server in a child OS process behind the line-JSON control
    channel. ``start()`` spawns (the ``fleet.replica_spawn`` chaos site lives
    in the supervisor's retry wrapper); ``wait_ready`` blocks until the child
    reports its model built and its serve loop entered."""

    def __init__(self, spec: ReplicaSpec, name: str = "replica-0",
                 clock: Callable[[], float] = time.monotonic, ack_timeout: float = ACK_TIMEOUT_S):
        self.spec = spec
        self.name = name
        self._clock = clock
        self._ack_timeout = ack_timeout
        self._proc: Optional[subprocess.Popen] = None
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._next_id = 0
        self._pendings: Dict[int, FleetPending] = {}
        self._replies: Dict[int, "queue.Queue[dict]"] = {}
        self._ready = threading.Event()
        self._eof = False
        self._inflight = 0
        self.last_status: Optional[dict] = None
        self.last_heartbeat: float = 0.0
        self.exit_rc: Optional[int] = None

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> "ProcessReplica":
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "orion_tpu_torch.fleet._child"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=None, text=True, cwd=repo_root,
            env=env)
        try:
            self._send_raw(self.spec.to_json())
        except Exception:
            # the spec never reached the child (a broken pipe, an injected
            # fleet.control_io fault): reap it here, or the spawn-retry loop
            # leaks one live process an attempt
            self._proc.kill()
            self._proc.wait(timeout=10.0)
            raise
        t = threading.Thread(target=self._read_loop, name=f"{self.name}-reader", daemon=True)
        t.start()
        return self

    def wait_ready(self, timeout: float = 180.0) -> None:
        if not self._ready.wait(timeout=timeout):
            self.kill()
            raise ReplicaGone(f"{self.name}: child not ready within {timeout}s")
        if not self.alive:
            raise ReplicaGone(f"{self.name}: child died during startup")

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None and not self._eof

    @property
    def inflight(self) -> int:
        with self._state_lock:
            return self._inflight

    def health_state(self) -> str:
        if not self.alive:
            return "dead"
        if self.last_status is not None:
            return self.last_status.get("state", "serving")
        return "serving" if self._ready.is_set() else "starting"

    # -- control channel ---------------------------------------------------------

    def _send_raw(self, line: str) -> None:
        fire("fleet.control_io")
        with self._send_lock:
            assert self._proc is not None and self._proc.stdin is not None
            self._proc.stdin.write(line + "\n")
            self._proc.stdin.flush()

    def _send(self, obj: dict) -> None:
        # every control-channel op into the black box (parent side): after a
        # chaos event the ring shows the ops the child saw last
        flight.record("control_op", replica=self.name, op=obj.get("op"))
        try:
            self._send_raw(json.dumps(obj))
        except (OSError, ValueError, BrokenPipeError, AssertionError) as e:
            flight.record("control_io_error", replica=self.name, error=type(e).__name__)
            raise ReplicaGone(f"{self.name}: control channel write failed ({e})") from e

    def _read_loop(self) -> None:
        proc = self._proc
        assert proc is not None and proc.stdout is not None
        for line in proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue  # stray non-protocol output: ignore, never die
            self._dispatch(msg)
        # EOF: the child exited (a clean drain or a crash)
        self._eof = True
        # the pipe closes a moment before the exit status is reapable: wait
        # for it (bounded) so an exit is never read as None
        try:
            self.exit_rc = proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            self.exit_rc = proc.poll()
        flight.record("replica_exit", replica=self.name, rc=self.exit_rc)
        if self.exit_rc not in (0, None):
            # an unhandled child exit dumps the parent's ring: the control
            # ops that preceded the death
            flight.recorder().dump(f"child-exit-{self.name}")
        self._fail_outstanding(ReplicaGone(f"{self.name}: replica exited (rc={self.exit_rc})"))
        self._ready.set()  # unblock any wait_ready (its alive check fails it)

    def _dispatch(self, msg: dict) -> None:
        if "reply_to" in msg:
            q = self._replies.pop(int(msg["reply_to"]), None)
            if q is not None:
                q.put(msg)
            return
        event = msg.get("event")
        if event == "ready":
            self._ready.set()
        elif event == "result":
            with self._state_lock:
                pending = self._pendings.pop(int(msg["id"]), None)
                if pending is not None:
                    self._inflight -= 1
            if pending is None:
                return
            if "error" in msg:
                pending.error = _rebuild_error(msg["error"], msg.get("message", ""))
            else:
                pending.result = _result_from_wire(msg)
            pending.done_at = self._clock()
            pending.replica = self.name
            pending._release()

    def _fail_outstanding(self, err: Exception) -> None:
        with self._state_lock:
            pendings = list(self._pendings.values())
            self._pendings.clear()
            self._inflight = 0
            replies = list(self._replies.values())
            self._replies.clear()
        for p in pendings:
            if not p.done.is_set():
                p.error = err
                p.done_at = self._clock()
                p._release()
        for q in replies:
            q.put({"ok": False, "error": "ReplicaGone", "message": str(err)})

    def _rpc(self, obj: dict, timeout: float) -> Optional[dict]:
        """Send one op and wait for its reply (bounded); None = timed out,
        the caller's missed-heartbeat signal."""
        with self._state_lock:
            self._next_id += 1
            rid = self._next_id
            q: "queue.Queue[dict]" = queue.Queue()
            self._replies[rid] = q
        obj = dict(obj, id=rid)
        try:
            self._send(obj)
        except ReplicaGone:
            self._replies.pop(rid, None)
            raise
        try:
            return q.get(timeout=timeout)
        except queue.Empty:
            self._replies.pop(rid, None)
            return None

    # -- the handle interface ----------------------------------------------------

    def submit(self, request: DecodeRequest) -> FleetPending:
        if not self.alive:
            raise ReplicaGone(f"{self.name}: not alive")
        pending = FleetPending(session_id=request.session_id, done=threading.Event(),
                               submitted_at=self._clock(), replica=self.name)
        with self._state_lock:
            self._next_id += 1
            rid = self._next_id
            self._pendings[rid] = pending
            self._inflight += 1
            q: "queue.Queue[dict]" = queue.Queue()
            self._replies[rid] = q
        msg = dict(_request_to_wire(request), op="submit", id=rid)
        try:
            self._send(msg)
            reply = q.get(timeout=self._ack_timeout)
        except (ReplicaGone, queue.Empty) as e:
            if isinstance(e, queue.Empty) and request.session_id is not None:
                # a SESSION submit written but never acknowledged may still
                # sit in the wedged child's stdin while the router fails
                # over: kill the child to FENCE it (the supervisor respawns),
                # or its late copy would fork the conversation. A sessionless
                # duplicate is harmless (its late result is dropped), and a
                # failed send needs no fence (nothing will read it).
                self.kill()
            with self._state_lock:
                if self._pendings.pop(rid, None) is not None:
                    self._inflight -= 1
            self._replies.pop(rid, None)
            raise ReplicaGone(f"{self.name}: submit not acknowledged ({type(e).__name__})") from e
        if not reply.get("ok"):
            with self._state_lock:
                if self._pendings.pop(rid, None) is not None:
                    self._inflight -= 1
            raise _rebuild_error(reply.get("error", "RuntimeError"), reply.get("message", ""))
        return pending

    def status(self, timeout: float = 2.0) -> Optional[dict]:
        if not self.alive:
            return None
        try:
            reply = self._rpc({"op": "status"}, timeout=timeout)
        except ReplicaGone:
            return None
        if reply is None or not reply.get("ok"):
            return None
        self.last_status = reply["status"]
        self.last_heartbeat = self._clock()
        return self.last_status

    def drain(self) -> None:
        """Graceful: a real SIGTERM to the child; the server's PreemptionGuard
        turns it into DRAINING (sessions suspend to the shared store,
        sessionless work completes, exit 0)."""
        if self._proc is not None and self._proc.poll() is None:
            try:
                os.kill(self._proc.pid, signal.SIGTERM)
            except OSError:
                pass

    def kill(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()

    def join(self, timeout: float = 10.0) -> bool:
        if self._proc is None:
            return True
        try:
            self.exit_rc = self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return False
        return True


# -- local replica: the same interface, in this process --------------------------------


class ReplicaKilled(RuntimeError):
    """Raised inside a LocalReplica's serve loop by ``kill()``: a SIGKILLed
    process -- no drain, no suspension, pendings fail with their partial
    tokens, the on-disk session generations stay as they were."""


class _LoopGuard:
    """A PreemptionGuard stand-in for the thread transport: ``drain`` flips
    ``should_stop`` (the serve loop's SIGTERM path), ``kill`` makes the NEXT
    ``should_stop`` read raise once (the loop dies mid-flight, its failure
    path runs, the thread exits)."""

    signum = signal.SIGTERM

    def __init__(self):
        self._stop = False
        self._kill = False
        self._raised = False

    def request_stop(self) -> None:
        self._stop = True

    def request_kill(self) -> None:
        self._kill = True
        self._stop = True

    @property
    def should_stop(self) -> bool:
        if self._kill and not self._raised:
            self._raised = True
            raise ReplicaKilled("replica killed")
        return self._stop


class LocalReplica(ReplicaHandle):
    """The server on a thread behind the ReplicaHandle interface (tests, the
    CLI's ``--local``). Shares the process's model, so a fleet of these
    holds one copy of the weights (a ``qmode`` Server quantizes its own)."""

    def __init__(self, model, cfg, name: str = "local-0",
                 clock: Callable[[], float] = time.monotonic):
        from orion_tpu_torch.serving.server import Server

        self.name = name
        self._clock = clock
        self.server = Server(model, cfg, clock=clock)
        self._guard = _LoopGuard()
        self._thread: Optional[threading.Thread] = None
        self._outstanding: List[Any] = []
        self._lock = threading.Lock()
        self.crashed = False
        self.last_heartbeat: float = 0.0
        self.last_status: Optional[dict] = None

    def start(self) -> "LocalReplica":
        self._thread = threading.Thread(target=self._run, name=f"{self.name}-serve", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            self.server.serve(guard=self._guard)
        except ReplicaKilled:
            self.crashed = True
        except Exception:
            self.crashed = True
            raise

    def wait_ready(self, timeout: float = 60.0) -> None:
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            if self._thread is not None and self._thread.is_alive():
                return
            time.sleep(0.01)
        raise ReplicaGone(f"{self.name}: serve thread did not start")

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def inflight(self) -> int:
        with self._lock:
            self._outstanding = [p for p in self._outstanding if not p.done.is_set()]
            return len(self._outstanding)

    def health_state(self) -> str:
        if not self.alive:
            return "dead"
        return self.server.health.state.value

    def submit(self, request: DecodeRequest):
        if not self.alive:
            raise ReplicaGone(f"{self.name}: not alive")
        pending = self.server.submit(request)
        with self._lock:
            self._outstanding.append(pending)
        return pending

    def status(self, timeout: float = 2.0) -> Optional[dict]:
        if not self.alive:
            return None
        snap = self.server.snapshot()
        self.last_heartbeat = self._clock()
        # as ProcessReplica: the freshest snapshot hangs off the handle, where
        # the router's slo_penalty and health_state read it
        self.last_status = snap
        return snap

    def drain(self) -> None:
        self._guard.request_stop()

    def kill(self) -> None:
        self._guard.request_kill()

    def join(self, timeout: float = 10.0) -> bool:
        if self._thread is None:
            return True
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()


# -- the child process ------------------------------------------------------------------


def _child_main() -> int:
    """``python -m orion_tpu_torch.fleet._child``: read the ReplicaSpec as
    the first stdin line, build the server on the spec's device (a child
    without the card it was asked for raises here, before it reports ready),
    report ready, then serve until a SIGTERM, a ``shutdown`` op or stdin EOF
    drains the loop. Control ops arrive as later stdin lines; replies,
    ``result`` events and the final ``exit`` event go to stdout, one JSON
    object a line (stdout is the protocol; diagnostics go to stderr)."""
    spec = ReplicaSpec.from_json(sys.stdin.readline())
    pinned = None
    if spec.compute_cpus and hasattr(os, "sched_setaffinity"):
        allowed = set(os.sched_getaffinity(0))
        pinned = {c for c in spec.compute_cpus if c in allowed} or None
        if pinned:
            os.sched_setaffinity(0, pinned)

    import torch

    from orion_tpu_torch.resilience import inject
    from orion_tpu_torch.resilience.preempt import PreemptionGuard
    from orion_tpu_torch.serving.server import Server

    out_lock = threading.Lock()

    def emit(obj: dict) -> None:
        with out_lock:
            sys.stdout.write(json.dumps(obj) + "\n")
            sys.stdout.flush()

    if pinned:
        # the CPU ops' thread pool sized to the pinned cores, not the host's
        torch.set_num_threads(len(pinned))
    plan = None
    if spec.faults:
        plan = inject.FaultPlan()
        for entry in spec.faults:
            getattr(plan, entry["kind"])(*entry.get("args", []))

    model, params_id = build_model(spec)
    cfg = serve_config(spec, params_id=params_id)
    server = Server(model, cfg)
    del model
    watchers: List[threading.Thread] = []

    def watch(rid: int, pending) -> None:
        # bounded waits only: re-arm until the pending resolves (serve()'s
        # finally guarantees it does, even on a crashing loop)
        while not pending.done.wait(timeout=1.0):
            pass
        if pending.error is not None:
            emit({"event": "result", "id": rid, "error": type(pending.error).__name__,
                  "message": str(pending.error)})
        else:
            emit(dict(_result_to_wire(pending.result), event="result", id=rid))

    with PreemptionGuard(grace=cfg.grace) as guard:

        def control() -> None:
            for line in sys.stdin:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                rid = int(msg.get("id", 0))
                op = msg.get("op")
                if op == "status":
                    emit({"reply_to": rid, "ok": True, "replica": True,
                          "status": server.snapshot()})
                elif op == "submit":
                    try:
                        pending = server.submit(_request_from_wire(msg))
                    except Exception as e:
                        emit({"reply_to": rid, "ok": False, "error": type(e).__name__,
                              "message": str(e)})
                        continue
                    t = threading.Thread(target=watch, args=(rid, pending), daemon=True)
                    watchers[:] = [w for w in watchers if w.is_alive()]
                    watchers.append(t)
                    t.start()
                    emit({"reply_to": rid, "ok": True})
                elif op == "shutdown":
                    emit({"reply_to": rid, "ok": True})
                    guard.request_stop()
                else:
                    emit({"reply_to": rid, "ok": False, "error": "ValueError",
                          "message": f"unknown op {op!r}"})
            # the parent hung up: drain, don't orphan
            guard.request_stop()

        threading.Thread(target=control, daemon=True).start()
        emit({"event": "ready", "pid": os.getpid()})
        rc = 1
        try:
            if plan is not None:
                with inject.inject(plan):
                    rc = server.serve(guard=guard)
            else:
                rc = server.serve(guard=guard)
        finally:
            server.close()
            # a drain resolves every pending (suspended / completed /
            # rejected): give their watchers a bounded window to EMIT those
            # results before the exit reaps them
            for t in watchers:
                t.join(timeout=5.0)
    emit({"event": "exit", "rc": rc})
    return rc


__all__ = ["ACK_TIMEOUT_S", "FleetPending", "LocalReplica", "ProcessReplica", "ReplicaGone",
           "ReplicaHandle", "ReplicaKilled", "ReplicaSpec", "build_model", "serve_config"]
