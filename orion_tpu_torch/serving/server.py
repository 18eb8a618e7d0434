"""Bounded-admission continuous-batching server over a SlotEngine: the port's
counterpart of ``orion_tpu/serving/server.py``.

The serve loop is a scheduler over :class:`~orion_tpu_torch.serving.batching.
SlotEngine`: up to ``slots`` requests decode together in one batched carry,
and admission, drain, deadlines and watchdog beats all happen at chunk
boundaries.

- **admission** -- a bounded queue (``max_inflight`` bounds the QUEUED
  backlog; up to ``slots`` more are resident in the engine); a full queue
  SHEDS the request with :class:`OverloadError` at submit time instead of
  growing a backlog whose tail is all deadline misses. A draining or dead
  server REJECTS with :class:`RejectedError`. Queued requests move into free
  slots at every chunk boundary, so a late arrival joins mid-stream.
- **health** -- the :class:`~orion_tpu_torch.serving.health.HealthMachine`
  drives admission: SERVING / DEGRADED accept, DRAINING / DEAD reject. A
  request that needed the degradation ladder (or a watchdog stall) moves
  SERVING -> DEGRADED; a clean completion recovers to SERVING.
- **SIGTERM** -- the PreemptionGuard around the serve loop maps the first
  signal to DRAINING at the next chunk boundary: in-flight slots AND
  already-queued requests complete, new submits are rejected, the loop
  returns 0. A second signal kills.
- **watchdog** -- ``stall_timeout`` arms a heartbeat watchdog beaten at every
  chunk boundary and admission; a stalled chunk degrades health and writes
  a diagnosis instead of hanging the replica silently.
- **request isolation** -- a request the engine cannot multiplex (a batch of
  rows, a prompt past the buckets or ``max_seq_len``, another SampleConfig
  than the resident batch's) or whose slot exhausts the per-slot ladder
  becomes an error / failed RESULT on its Pending; the slots beside it keep
  streaming and the process never dies for one request.
- **telemetry** -- a per-server ``MetricsRegistry`` (the ``stats`` counters,
  ``chunk_ms``, ``turn_latency_ms``, ladder and health counters, queue and
  slot gauges), a ``Tracer`` (request and queue spans, one complete event
  per resident slot per boundary) and a ``FlightRecorder`` that dumps on
  DEGRADED / DRAINING / DEAD, ladder exhaustion and watchdog stalls. All of
  it records host values the scheduler already holds: the Server reads the
  card nowhere; the engine reads it once a boundary attempt and once a
  request.

``ServeConfig.qmode`` quantizes the handed model once at construction
(``generate.quantize_for_decode``); every slot then shares the int8 / int4
weights. The server runs on the model's device (the card unless the model
is on the CPU).

Left out, each refused with ``NotImplementedError`` naming its ROADMAP.md
item when its ``ServeConfig`` field is set: durable sessions and their
store, breakers and dirty write-behind (``session_dir``, ``session_*``,
``max_resident_sessions``, ``max_dirty_sessions``, ``breaker_*``) and the
prefix cache (``prefix_dir``, ``prefix_keep``, ``params_id``): A8 step 3;
speculation (``spec_depth``, ``spec_min_accept``): A8 step 4; tensor-parallel
serving (``tp``, ``mesh_audit``): A12; cost attribution and capacity
(``cost``, ``cost_ledger``, ``capacity_window_s``), SLOs (``slo``,
``slo_degrade_ticks``), the live HTTP endpoints (``metrics_port``) and
on-demand profiling (``profile_dir``): A9; the executable store
(``exec_dir``, ``exec_local_dir``, ``exec_max_resident``): A13. A request
carrying a ``session_id`` is refused at admission as the reference refuses
it without a session store. ``cost`` and ``mesh_audit`` default to False
here (True in the reference): the port computes neither.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import sys
import threading
import time
import uuid
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from orion_tpu_torch.generate import quantize_for_decode
from orion_tpu_torch.obs.flight import FlightRecorder
from orion_tpu_torch.obs.metrics import MetricsRegistry
from orion_tpu_torch.obs.trace import Tracer
from orion_tpu_torch.resilience.inject import fire
from orion_tpu_torch.resilience.preempt import PreemptionGuard
from orion_tpu_torch.resilience.retry import RetryPolicy, call_with_retries
from orion_tpu_torch.resilience.watchdog import Watchdog
from orion_tpu_torch.serving.batching import SlotEngine, parse_buckets
from orion_tpu_torch.serving.health import Health, HealthMachine
from orion_tpu_torch.serving.session import DecodeRequest, DecodeResult
from orion_tpu_torch.utils.device import resolve_device

# the Server.stats contract: these counter names, unlabelled, as one flat
# dict read from the metrics registry's cells (the session counters stay 0
# until the session store is ported)
_STAT_KEYS = (
    "admitted", "shed", "rejected",
    "ok", "deadline", "failed",
    "rewinds", "reprefills", "stalls",
    "chunks", "slot_steps_active", "slot_steps_total",
    "suspended", "resumed", "session_saves",
)

# ServeConfig fields of the reference that the port does not serve yet ->
# the ROADMAP.md item that brings each; a value other than the default
# raises at construction
_NOT_PORTED = {
    **dict.fromkeys(("session_dir", "session_idle_s", "max_resident_sessions", "session_keep",
                     "max_dirty_sessions", "breaker_failures", "breaker_backoff",
                     "breaker_max_backoff", "prefix_dir", "prefix_keep", "params_id"),
                    "A8 step 3"),
    **dict.fromkeys(("spec_depth", "spec_min_accept"), "A8 step 4"),
    **dict.fromkeys(("tp", "mesh_audit"), "A12"),
    **dict.fromkeys(("cost", "cost_ledger", "capacity_window_s", "slo", "slo_degrade_ticks",
                     "metrics_port", "profile_dir"), "A9"),
    **dict.fromkeys(("exec_dir", "exec_local_dir", "exec_max_resident"), "A13"),
}


class OverloadError(RuntimeError):
    """Admission queue full: the request was shed, not queued."""


class RejectedError(RuntimeError):
    """The server is draining or dead and accepts no new requests."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    chunk: int = 16  # decode chunk length (deadline / abort granularity)
    slots: int = 8  # concurrent decode slots (one carry row each), at most 64
    max_inflight: int = 8  # admission bound on the QUEUED backlog
    deadline_ms: float = 0.0  # default per-request deadline (0 = none)
    stall_timeout: float = 0.0  # watchdog heartbeat budget (0 = off)
    grace: float = 30.0  # SIGTERM drain budget
    poll: float = 0.05  # idle queue poll cadence (seconds)
    prefill_buckets: str = "pow2"  # pad-to-bucket prompt lengths ("" = off)
    # in-scan chunked prefill: prompt tokens consumed per chunk boundary
    # inside the batched program (rounded up to the linear-attention
    # chunk); 0 = host prefill at admission
    prefill_chunk: int = 64
    # prompts longer than the largest bucket: "error" refuses the request,
    # "clamp" serves the newest bucket-sized context
    prompt_overflow: str = "error"
    # "off" | "int8" | "int4": the model is quantized once at construction
    # and every slot shares the quantized weights
    qmode: str = "off"
    # Prometheus text dumped here (+ a .json sibling) every
    # metrics_interval_s at chunk boundaries and always on drain / exit;
    # None = no exposition (the registry still records)
    metrics_path: Optional[str] = None
    metrics_interval_s: float = 10.0  # <= 0: dump on drain only
    # Chrome trace-event JSONL of request / queue / chunk spans; None = off
    trace_path: Optional[str] = None
    # flight-recorder dumps land here; None = ring only, no dumps
    flight_dir: Optional[str] = None
    # -- not ported: a value other than these raises (see _NOT_PORTED) --
    prefix_dir: Optional[str] = None
    prefix_keep: int = 2
    params_id: Optional[str] = None
    exec_dir: Optional[str] = None
    exec_local_dir: Optional[str] = None
    exec_max_resident: int = 32
    session_dir: Optional[str] = None
    session_idle_s: float = 300.0
    max_resident_sessions: int = 64
    session_keep: int = 2
    breaker_failures: int = 3
    breaker_backoff: float = 0.5
    breaker_max_backoff: float = 30.0
    max_dirty_sessions: int = 32
    metrics_port: int = -1
    slo: Optional[tuple] = None
    slo_degrade_ticks: int = 3
    spec_depth: int = 0
    spec_min_accept: float = 0.2
    tp: int = 0
    mesh_audit: bool = False
    cost: bool = False
    cost_ledger: bool = False
    capacity_window_s: float = 30.0
    profile_dir: Optional[str] = None


def _check_ported(cfg: ServeConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP.md item of every
    field of ``cfg`` that asks for a part of the reference's server the
    port does not have yet (``tp`` 0 and 1 both mean unsharded)."""
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if f.name in _NOT_PORTED and value != f.default and not (f.name == "tp" and value == 1):
            raise NotImplementedError(
                f"ServeConfig.{f.name}={value!r} is not ported to orion_tpu_torch yet "
                f"(ROADMAP.md queue A, {_NOT_PORTED[f.name]})")


@dataclasses.dataclass
class Pending:
    """A submitted request's handle; ``done`` is set exactly once, with
    either ``result`` or ``error`` filled. ``admitted_at`` anchors the
    request's deadline (queue wait counts against it); ``done_at`` records
    completion."""

    request: DecodeRequest
    done: threading.Event
    admitted_at: float = 0.0
    result: Optional[DecodeResult] = None
    error: Optional[Exception] = None
    done_at: float = 0.0
    # trace identity: the async-span id every event of this request carries
    rid: str = ""
    # called exactly once, right after ``done`` fires; host-only, and a
    # raising callback is ignored
    on_done: Optional[Callable[["Pending"], None]] = None

    def wait(self, timeout: Optional[float] = None) -> Optional[DecodeResult]:
        """Block for the outcome: the DecodeResult, or RAISE the request's
        recorded error (rejection at shutdown, a refused request); None
        only on timeout, so a dropped request can't pass for a slow one."""
        if not self.done.wait(timeout=timeout):
            return None
        if self.error is not None:
            raise self.error
        return self.result


def load_tokenizer(path: Optional[str] = None, retry: Optional[RetryPolicy] = None):
    """The tokenizer behind the checkpoint load's jittered-backoff retry: a
    storage blip on the tokenizer JSON must not kill a replica. ``None`` =
    the byte-level tokenizer (no I/O beyond the hook)."""

    def _load():
        fire("serve.tokenizer_io")
        if path:
            from orion_tpu_torch.utils.bpe import BPETokenizer

            return BPETokenizer.load(path)
        from orion_tpu_torch.utils.tokenizer import ByteTokenizer

        return ByteTokenizer()

    return call_with_retries(_load, retry if retry is not None else RetryPolicy(),
                             describe="tokenizer load")


def _host_prompt(prompt) -> np.ndarray:
    """A request's prompt as a host array: the scheduler never pays a read
    of the card for token ids."""
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu()
    return np.asarray(prompt, np.int64)


class Server:
    """Single-worker scheduler loop (decode serializes on the card anyway);
    ``submit`` is thread-safe and may be called from feeder threads.

    ``model``: a ``TransformerLM`` (full precision when ``cfg.qmode`` asks
    for quantization). ``device``: where the engine's carry lives, the
    model's device by default (the engine refuses any other)."""

    def __init__(
        self,
        model,
        cfg: ServeConfig = ServeConfig(),
        clock: Callable[[], float] = time.monotonic,
        tracer: Optional[Tracer] = None,
        flight: Optional[FlightRecorder] = None,
        device=None,
    ):
        _check_ported(cfg)
        self.cfg = cfg
        self._clock = clock
        self.qmode = (cfg.qmode or "off").lower()
        if self.qmode not in ("off", "int8", "int4"):
            raise ValueError(f"qmode must be one of off|int8|int4, got {cfg.qmode!r}")
        if self.qmode != "off":
            model = quantize_for_decode(model, self.qmode)
        self.device = model.device if device is None else resolve_device(device)
        # ONE reentrant lock guards the metrics registry AND the health
        # machine: snapshot() reads both under a single acquisition, so a
        # poller never sees a torn (health, occupancy) pair
        self._stats_lock = threading.RLock()
        self.metrics = MetricsRegistry(clock=clock, lock=self._stats_lock)
        for key in _STAT_KEYS:
            self.metrics.counter(key)
        self.trace = tracer if tracer is not None else Tracer(
            path=cfg.trace_path, clock=clock, enabled=bool(cfg.trace_path))
        self.flight = flight if flight is not None else FlightRecorder(
            clock=clock, dump_dir=cfg.flight_dir)
        self._h_chunk_ms = self.metrics.histogram("chunk_ms")
        self._h_turn_ms = self.metrics.histogram("turn_latency_ms")
        self._c_ladder = self.metrics.counter("ladder_rungs")
        self._c_health = self.metrics.counter("health_transitions")
        self._rid_seq = 0
        # a per-server token in every trace id: two servers sharing a trace
        # file never collide on span ids
        self._rid_token = uuid.uuid4().hex[:6]
        self._metrics_next = 0.0
        self.health = HealthMachine(clock=clock, lock=self._stats_lock,
                                    on_transition=self._on_health)
        self.engine = SlotEngine(
            model, slots=cfg.slots, chunk=cfg.chunk, clock=clock,
            prefill_buckets=parse_buckets(cfg.prefill_buckets, model.cfg.max_seq_len),
            prefill_chunk=cfg.prefill_chunk, prompt_overflow=cfg.prompt_overflow,
            on_event=self._on_engine_event, device=self.device)
        # gauges evaluated at scrape time from live host state
        self.metrics.gauge_fn("queue_depth", self._q_depth)
        for key in ("active", "free", "prefilling", "decoding"):
            self.metrics.gauge_fn("slots", self._slot_gauge(key), labels={"state": key})
        self._q: "queue.Queue[Pending]" = queue.Queue(maxsize=cfg.max_inflight)
        self._guard: Optional[PreemptionGuard] = None
        # makes (accepting check -> enqueue) atomic against the drain
        # path's final (reject leftovers -> DEAD): a put landing between the
        # loop's last empty-check and DEAD would strand a Pending
        self._admission_lock = threading.Lock()
        self._chunk_seq = 0  # serve.chunk_delay's step address

    @property
    def stats(self) -> Dict[str, int]:
        """The stats dict, read from the registry's unlabelled counter cells
        (one consistent acquisition). A snapshot: mutate through the
        registry."""
        flat = self.metrics.counters_flat()
        return {k: flat.get(k, 0) for k in _STAT_KEYS}

    def _bump(self, key: str, n: int = 1) -> None:
        self.metrics.counter(key).inc(n)

    # -- telemetry hooks (all host-only) -------------------------------------

    def _q_depth(self) -> int:
        return self._q.qsize()

    def _slot_gauge(self, key: str) -> Callable[[], int]:
        return lambda: self.engine.occupancy()[key]

    def _on_health(self, old, new, reason: str) -> None:
        """HealthMachine transition tap (after the machine released the
        shared lock): a flight event and a counter; DEGRADED, DRAINING and
        DEAD dump the flight recorder."""
        self.flight.record("health", frm=old.value if old else None, to=new.value,
                           reason=reason)
        self._c_health.inc(labels={"to": new.value})
        if new in (Health.DEGRADED, Health.DRAINING, Health.DEAD):
            self.flight.dump(f"health-{new.value}")

    def _on_engine_event(self, kind: str, fields: dict) -> None:
        """SlotEngine tap (admit, resume, prefill_piece, ladder, evict):
        recorded to the flight ring with the tag swapped for the request's
        trace id; ladder rungs counted and traced, admissions traced."""
        tag = fields.pop("tag", None)
        rid = getattr(tag, "rid", None)
        if rid is not None:
            fields["req"] = rid
        self.flight.record(kind, **fields)
        if kind == "ladder":
            self._c_ladder.inc(labels={"rung": fields.get("rung", "?")})
            self.trace.instant("ladder", id=rid, rung=fields.get("rung"),
                               slot=fields.get("slot"))
        elif kind in ("admit", "resume"):
            self.trace.instant(kind, id=rid, session=fields.get("session"),
                               slot=fields.get("slot"))

    # -- admission -----------------------------------------------------------

    def submit(self, request: DecodeRequest) -> Pending:
        """Queue a request or refuse loudly: RejectedError when draining /
        dead, OverloadError when the bounded queue is full (shed: the
        caller retries elsewhere)."""
        if request.deadline_ms <= 0 and self.cfg.deadline_ms > 0:
            request = dataclasses.replace(request, deadline_ms=self.cfg.deadline_ms)
        request = dataclasses.replace(request, prompt=_host_prompt(request.prompt))
        pending = Pending(request, threading.Event(), admitted_at=self._clock())
        with self._admission_lock:
            if not self.health.accepting:
                self._bump("rejected")
                raise RejectedError(f"server is {self.health.state.value}")
            self._rid_seq += 1
            pending.rid = (f"{request.session_id}:{self._rid_token}.{self._rid_seq}"
                           if request.session_id is not None
                           else f"req-{self._rid_token}.{self._rid_seq}")
            # the spans open BEFORE the enqueue: the loop may pop the Pending
            # (and end them) the instant put_nowait returns; a shed request
            # closes both right here, so pairing stays complete
            self.trace.begin("request", pending.rid, session=request.session_id)
            self.trace.begin("queue", pending.rid)
            try:
                self._q.put_nowait(pending)
            except queue.Full:
                self._bump("shed")
                self.trace.end("queue", pending.rid)
                self.trace.end("request", pending.rid, status="shed")
                raise OverloadError(
                    f"admission queue full ({self.cfg.max_inflight} queued + up to "
                    f"{self.cfg.slots} resident in slots)") from None
        self._bump("admitted")
        return pending

    # -- serve loop ----------------------------------------------------------

    def serve(self, drain_when_idle: bool = False,
              guard: Optional[PreemptionGuard] = None) -> int:
        """Run the serve loop. Returns 0 on a graceful exit: a SIGTERM drain
        completed (health ends DEAD) or ``drain_when_idle`` found the queue
        empty (health stays SERVING: callers may submit and serve again;
        ``close()`` finalizes).

        ``guard``: an installed PreemptionGuard to poll instead of
        installing one per call (the CLI's whole-lifecycle guard, so a
        SIGTERM between waves still drains)."""
        cfg = self.cfg
        wd = None
        if cfg.stall_timeout > 0:
            wd = Watchdog(cfg.stall_timeout, on_stall=self._on_stall, monitor=True,
                          label="serve loop", observer=self._on_wd)
        with contextlib.ExitStack() as stack:
            if guard is None:
                guard = stack.enter_context(PreemptionGuard(grace=cfg.grace, clock=self._clock))
            self._guard = guard
            # every delivered fault leaves a ring event for the serve lifetime
            self.flight.attach_inject()
            stack.callback(self.flight.detach_inject)
            if self.health.state is Health.STARTING:
                self.health.to(Health.SERVING, "serve loop running")
            clean_exit = False
            try:
                # admit queued requests into free slots, advance every
                # resident slot one chunk, complete the finished. DRAINING
                # still admits the queued backlog (in-flight AND queued
                # requests complete); only submit() is closed.
                while True:
                    self._maybe_drain(guard)
                    draining = self.health.state is Health.DRAINING
                    self._tick_metrics()
                    self._admit_from_queue(wd)
                    if not self.engine.busy:
                        if (draining or drain_when_idle) and self._q.empty():
                            break
                        try:
                            pending = self._q.get(timeout=cfg.poll)
                        except queue.Empty:
                            continue
                        self._admit(pending, wd)
                        continue
                    self._step_chunk(wd, guard)
                clean_exit = True
            finally:
                if not clean_exit:
                    # the loop RAISED mid-chunk: resident requests complete
                    # as 'failed' with their tokens so far, queued ones are
                    # rejected -- no Pending's done event is left unset
                    for pending, result in self.engine.drain_evict_all("failed"):
                        self._complete(pending, result)
                    self._reject_leftovers()
                if wd is not None:
                    wd.close()
                self._guard = None
                # under the admission lock: once DEAD is published no
                # submit can slip a Pending into the dead queue
                with self._admission_lock:
                    self._maybe_drain(guard)
                    if self.health.state is Health.DRAINING:
                        self._reject_leftovers()
                        self.health.to(Health.DEAD, "drained")
                self._tick_metrics(force=True)
                self.trace.flush()
        return 0

    def _tick_metrics(self, force: bool = False) -> None:
        """Periodic metrics exposition at chunk-boundary cadence (forced on
        drain / exit). An interval <= 0 dumps on drain only; a failing dump
        never takes the serve loop down."""
        path = self.cfg.metrics_path
        if not path:
            return
        now = self._clock()
        if not force and (self.cfg.metrics_interval_s <= 0 or now < self._metrics_next):
            return
        self._metrics_next = now + max(self.cfg.metrics_interval_s, 1.0)
        try:
            self.metrics.dump(path)
        except OSError as e:
            warnings.warn(f"metrics dump failed: {e}", stacklevel=2)

    def close(self) -> None:
        """Finalize a server whose loop exited idle: reject anything still
        queued and go DEAD."""
        with self._admission_lock:
            self._reject_leftovers()
            if self.health.state is not Health.DEAD:
                self.health.to(Health.DEAD, "closed")

    # -- scheduler internals -------------------------------------------------

    def _admit_from_queue(self, wd=None) -> None:
        """Move queued requests into free slots (every chunk boundary: where
        a late arrival joins the running batch)."""
        while self.engine.has_free_slot:
            try:
                pending = self._q.get_nowait()
            except queue.Empty:
                return
            self._admit(pending, wd)

    def _admit(self, pending: Pending, wd=None) -> None:
        """Place one Pending into a slot. A request whose whole deadline
        elapsed in the queue completes as 'deadline' with zero tokens (no
        prefill paid); one the engine cannot multiplex becomes an error
        RESULT (isolation) -- the batch keeps streaming either way."""
        if wd is not None:
            # an admission burst runs up to `slots` solo prefills before
            # the next chunk beat: beat per admission
            wd.beat("request admission")
        self.trace.end("queue", pending.rid)
        deadline_at = (pending.admitted_at + pending.request.deadline_ms / 1000.0
                       if pending.request.deadline_ms > 0 else None)
        if deadline_at is not None and self._clock() >= deadline_at:
            self._complete(pending, DecodeResult(tokens=np.zeros((1, 0), np.int64),
                                                 status="deadline", new_tokens=0, chunks=0))
            return
        try:
            if pending.request.session_id is not None:
                raise ValueError("request carries a session_id but durable sessions are not "
                                 "ported to orion_tpu_torch yet (ROADMAP.md queue A, A8 step 3)")
            self.engine.admit(pending.request, tag=pending, deadline_at=deadline_at)
        except Exception as e:
            # request isolation: an unadmittable request is an error RESULT,
            # never a dead process and never a stuck batch
            pending.error = e
            self._bump("failed")
            self.flight.record("refused", req=pending.rid, error=type(e).__name__)
            self._degrade(f"request refused: {type(e).__name__}: {e}")
            self._finalize(pending, "error")

    def _step_chunk(self, wd, guard) -> None:
        """One engine boundary: watchdog beat, every slot advanced a chunk,
        the finished completed. The boundary's wall time is one ``chunk_ms``
        observation and, with tracing on, one complete event per resident
        slot (its phase from the engine's host mirrors; the duration is the
        shared batched program's)."""
        if wd is not None:
            wd.beat("decode chunk")
        self._maybe_drain(guard)
        occupied = self.engine.active_count
        infos = self.engine.slot_info() if self.trace.enabled else ()
        t0 = self._clock()
        finished = self.engine.step()
        self._chunk_seq += 1
        # INSIDE the timed window: injected latency lands in chunk_ms as a
        # slow boundary would
        fire("serve.chunk_delay", step=self._chunk_seq)
        dt = self._clock() - t0
        with self._stats_lock:
            self._bump("chunks")
            self._bump("slot_steps_active", occupied)
            self._bump("slot_steps_total", self.engine.slots)
            self._h_chunk_ms.observe(dt * 1e3)
        for i, tag, phase, k in infos:
            self.trace.complete("decode_chunk" if phase == "decode" else "prefill_piece",
                                t0, dt, req=getattr(tag, "rid", None), slot=i, chunk=k)
        for pending, result in finished:
            self._complete(pending, result)

    def _complete(self, pending: Pending, result: DecodeResult) -> None:
        pending.result = result
        self._bump(result.status)
        self._bump("rewinds", result.rewinds)
        self._bump("reprefills", result.reprefills)
        if result.status == "failed":
            # ladder exhaustion: the black box keeps the rungs that led here
            self.flight.dump("ladder-exhausted")
        if result.status == "failed" or result.degraded:
            self._degrade(f"request needed the ladder (rewinds={result.rewinds}, "
                          f"reprefills={result.reprefills}, status={result.status})")
        elif self.health.state is Health.DEGRADED:
            self.health.to(Health.SERVING, "clean request completed")
        self._finalize(pending, result.status)

    def _finalize(self, pending: Pending, status: str) -> None:
        """The one place a Pending's done event fires: stamps done_at,
        observes the turn latency (results only), closes the request's span,
        releases the waiter and runs ``on_done``."""
        pending.done_at = self._clock()
        if pending.result is not None:
            self._h_turn_ms.observe((pending.done_at - pending.admitted_at) * 1e3)
        self.trace.end("request", pending.rid, status=status,
                       session=pending.request.session_id)
        pending.done.set()
        cb = pending.on_done
        if cb is not None:
            try:
                cb(pending)
            except Exception:
                pass  # telemetry must never break completion

    def occupancy(self) -> float:
        """The fraction of slots holding a live request right now."""
        occ = self.engine.occupancy()
        return occ["active"] / occ["slots"] if occ["slots"] else 0.0

    def occupancy_lifetime(self) -> float:
        """Lifetime fraction of slot-chunks that carried a live request
        (1.0 = perfectly packed)."""
        with self._stats_lock:
            flat = self.metrics.counters_flat()
            total = flat.get("slot_steps_total", 0)
            return flat.get("slot_steps_active", 0) / total if total else 0.0

    def snapshot(self) -> dict:
        """Health + scheduler gauges in one payload, under ONE acquisition
        of the stats lock (the health machine and the registry share it)."""
        with self._stats_lock:
            snap = self.health.snapshot()
            snap["stats"] = dict(self.stats)
            snap["occupancy"] = self.occupancy_lifetime()
            snap["occupancy_now"] = self.occupancy()
            snap["slots"] = self.engine.occupancy()
            snap["queued"] = self._q.qsize()
            snap["metrics"] = self.metrics.snapshot()
        return snap

    def _maybe_drain(self, guard) -> None:
        if guard is not None and guard.should_stop and self.health.state in (
                Health.STARTING, Health.SERVING, Health.DEGRADED):
            self.health.to(Health.DRAINING, f"signal {guard.signum}: finish in-flight, reject new")

    def _degrade(self, reason: str) -> None:
        if self.health.state is Health.SERVING:
            self.health.to(Health.DEGRADED, reason)

    def _on_wd(self, event: str, detail: str) -> None:
        # watchdog tap: beats and stalls into the black box; a stall dumps
        self.flight.record("watchdog", event=event, detail=detail)
        if event == "stall":
            self.flight.dump("watchdog-stall")

    def _on_stall(self, diag: str) -> None:
        # the watchdog's monitor thread, not a signal handler: buffered io
        self._bump("stalls")
        sys.stderr.write(f"[serve] {diag}\n")
        self._degrade(f"watchdog: {diag}")

    def _reject_leftovers(self) -> None:
        while True:
            try:
                pending = self._q.get_nowait()
            except queue.Empty:
                return
            pending.error = RejectedError("server shut down before execution")
            self._bump("rejected")
            self.trace.end("queue", pending.rid)
            self._finalize(pending, "rejected")


__all__ = ["Server", "ServeConfig", "Pending", "OverloadError", "RejectedError",
           "load_tokenizer"]
