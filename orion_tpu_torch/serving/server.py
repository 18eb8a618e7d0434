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
- **durable sessions** -- with ``session_dir`` set, a request carrying a
  ``session_id`` is a conversation turn: its decode state is suspended at the
  turn's end as one O(1) snapshot (written through to the integrity-
  manifested :class:`~orion_tpu_torch.serving.session_store.SessionStore`, an
  LRU-capped host cache in front, idle eviction at chunk boundaries), and a
  later turn resumes it bitwise as if the slot had stayed resident, across
  restarts. A SIGTERM drain SUSPENDS resident sessions instead of decoding
  their remaining tokens; a corrupt session fails only its own request.
- **prefix cache** -- with ``prefix_dir`` set, admissions look their prompt
  up in the content-addressed
  :class:`~orion_tpu_torch.serving.prefix_store.PrefixStore` (a hit admits at
  O(suffix)); a miss that declares ``prefix_len`` queues a publish, run
  between boundaries with a watchdog beat.
- **storage failure domains** -- each store has its own circuit breaker
  (``breaker_*``). An open breaker fails every store touch in O(1) host work
  and latches health DEGRADED with reason ``store-outage:<store>``; requests
  keep serving (a prefix lookup is a cold prefill, a session save becomes a
  DIRTY write-behind pin retried at boundaries, at most
  ``max_dirty_sessions`` before new session turns shed retriably). Recovery
  needs the breakers closed AND the dirty backlog saved; a drain holds dirty
  sessions until its grace deadline, then names them and exits 0.
- **self-speculation** -- ``spec_depth > 0`` runs the engine's speculative
  rounds at pure-decode boundaries (``SlotEngine``): the tokens are the
  plain walk's, bitwise; ``spec_min_accept`` floors a slot whose rolling
  acceptance falls below it. The registry counts accepted, rejected and
  floored drafts (``spec_accepted_total``, ``spec_rejected_total``,
  ``spec_floor_total``) and observes each speculating request's acceptance
  at its eviction (``spec_accept_rate``); ``snapshot()`` has a
  ``speculation`` section.
- **telemetry** -- a per-server ``MetricsRegistry`` (the ``stats`` counters,
  ``chunk_ms``, ``turn_latency_ms``, ladder and health counters, queue and
  slot gauges), a ``Tracer`` (request and queue spans, one complete event
  per resident slot per boundary) and a ``FlightRecorder`` that dumps on
  DEGRADED / DRAINING / DEAD, ladder exhaustion and watchdog stalls. All of
  it records host values the scheduler already holds: the Server reads the
  card nowhere; the engine reads it once a boundary attempt and once a
  request.
- **cost attribution and capacity** -- ``cost`` (on by default) splits each
  boundary's measured ``chunk_ms`` over the resident slots by the work each
  did (``obs/cost.py``'s ``attribute_chunk``: the shares sum to
  ``chunk_ms``) and stamps every result with its ``device_ms``,
  ``cost_flops`` and prefill / decode token counts; a ``CapacityModel``
  folds the windowed ``chunk_ms`` into a tokens/s ceiling and headroom. The
  flops come from the analytic ``2 x params`` (the JAX package's leaf count
  of the served tree); the ledger harvest of compiled programs' costs
  (``cost_ledger``) is A13's.
- **SLOs** -- an ``SLOEngine`` over the same registry cells, ticked at every
  boundary: declared objectives (``slo``) arm actuation, so a fast burn that
  lasts ``slo_degrade_ticks`` boundaries degrades health and halves the
  admission bound; the observe-only defaults only report.
- **live endpoints** -- ``metrics_port >= 0`` serves ``/metrics``,
  ``/healthz`` (its status code from the health state), ``/statusz``,
  ``/slo``, ``/costz`` and ``/profilez`` from a daemon thread
  (``obs/http.py``), every provider a host read.
- **on-demand profiling** -- with ``profile_dir`` set, ``arm_profile(K)``
  (or ``/profilez?chunks=K``) records the next K boundaries with
  ``torch.profiler`` into a Chrome trace (CPU ops and, on the card, CUDA
  kernels); the profiler starts and stops on the scheduler thread at
  boundaries only.

``ServeConfig.qmode`` quantizes the handed model once at construction
(``generate.quantize_for_decode``); every slot then shares the int8 / int4
weights, and both stores key on the weights' identity (``params_id`` +
qmode). The server runs on the model's device (the card unless the model is
on the CPU).

Left out, each refused with ``NotImplementedError`` naming its ROADMAP.md
item when its ``ServeConfig`` field is set: tensor-parallel serving (``tp``,
``mesh_audit``): A12; the cost ledger's harvest (``cost_ledger``: XLA's
``cost_analysis()`` of lowered executables in the reference) and the
executable store (``exec_dir``, ``exec_local_dir``, ``exec_max_resident``):
A13. ``mesh_audit`` defaults to False here (True in the reference): the port
has no mesh to audit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import sys
import threading
import time
import uuid
import warnings
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from orion_tpu_torch.convert import expected_params
from orion_tpu_torch.generate import quantize_for_decode
from orion_tpu_torch.obs import cost as obs_cost
from orion_tpu_torch.obs import slo as obs_slo
from orion_tpu_torch.obs.flight import FlightRecorder
from orion_tpu_torch.obs.http import ObsHTTPServer
from orion_tpu_torch.obs.metrics import MetricsRegistry
from orion_tpu_torch.obs.trace import Tracer
from orion_tpu_torch.resilience.breaker import CircuitBreaker, StoreUnavailableError
from orion_tpu_torch.resilience.inject import fire
from orion_tpu_torch.resilience.preempt import PreemptionGuard
from orion_tpu_torch.resilience.retry import RetryPolicy, call_with_retries
from orion_tpu_torch.resilience.watchdog import Watchdog
from orion_tpu_torch.serving.batching import SlotEngine, parse_buckets
from orion_tpu_torch.serving.health import HTTP_STATUS, Health, HealthMachine
from orion_tpu_torch.serving.prefix_store import PrefixStore, params_identity
from orion_tpu_torch.serving.session import DecodeRequest, DecodeResult
from orion_tpu_torch.serving.session_store import SessionState, SessionStore
from orion_tpu_torch.utils.device import resolve_device

# the Server.stats contract: these counter names, unlabelled, as one flat
# dict read from the metrics registry's cells
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
    "tp": "A12 step 8", "mesh_audit": "A12",
    **dict.fromkeys(("cost_ledger", "exec_dir", "exec_local_dir", "exec_max_resident"), "A13"),
}
# why a refused field waits for its item, where the item's name alone does
# not say it
_NOT_PORTED_WHY = {
    "cost_ledger": "its figures are XLA's cost_analysis() of lowered executables in the "
                   "reference; without it attribution weighs by token counts and the flops "
                   "are the analytic 2 x params",
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
    # -- the content-addressed prefix cache (serving/prefix_store.py); None =
    # off. Needs in-scan prefill (prefill_chunk > 0): a hit admits as one
    # cached row plus the in-scan prefill of the suffix. Shared by every
    # replica pointing at the directory.
    prefix_dir: Optional[str] = None
    prefix_keep: int = 2  # generations kept per prefix entry
    # the WEIGHTS' identity the stores key on (config + checkpoint step or
    # init seed); None = a config hash (params_identity), fine for one model
    # a store; pin it when several checkpoints of one config share a store
    params_id: Optional[str] = None
    # -- durable sessions (serving/session_store.py); None = off --
    session_dir: Optional[str] = None  # the session store's root
    session_idle_s: float = 300.0  # resident-cache idle eviction (0 = off)
    max_resident_sessions: int = 64  # LRU cap of the host-resident cache
    session_keep: int = 2  # generations kept per session on disk
    # -- storage failure domains (resilience/breaker.py): one breaker a
    # store; after breaker_failures failed operations in a row it opens and
    # every store touch fails in O(1) host work until a jittered backoff ends
    # and one half-open probe tests the store. An open breaker reports health
    # DEGRADED "store-outage:<store>"; requests keep serving.
    breaker_failures: int = 3
    breaker_backoff: float = 0.5  # open dwell before the first probe
    breaker_max_backoff: float = 30.0  # probe backoff ceiling
    # write-behind bound in a session-store outage: past this many DIRTY
    # sessions (their save failed; the resident copy is the only current
    # one), NEW session turns shed with a retriable OverloadError. 0 = no
    # bound
    max_dirty_sessions: int = 32
    # -- self-speculative decode (SlotEngine): drafts a slot a round, 0 = off;
    # the per-slot rolling-acceptance floor below which a slot stops drafting
    # (0 = never) --
    spec_depth: int = 0
    spec_min_accept: float = 0.2
    # -- the live endpoints (obs/http.py): /metrics /healthz /statusz /slo
    # /costz /profilez on a daemon thread; -1 = none, 0 = an ephemeral port
    # (the bound one is Server.http_port). Every provider reads host state.
    metrics_port: int = -1
    # declared SLOs: Objective kwarg dicts (JSON-able, so they ride a
    # ReplicaSpec). None = the observe-only defaults (error rate and
    # availability at 99%): burn rates are computed either way, actuation
    # (DEGRADED and earlier shedding) arms only for declared objectives
    slo: Optional[tuple] = None
    # boundaries in a row with a fast-burn alert firing before the server
    # degrades itself and sheds early
    slo_degrade_ticks: int = 3
    # cost attribution and the capacity model (obs/cost.py): host arithmetic
    # at boundaries over chunk_ms, no read of the card
    cost: bool = True
    capacity_window_s: float = 30.0  # the CapacityModel's rolling window
    # torch.profiler captures armed by /profilez?chunks=K or arm_profile()
    # land here (one directory a capture, a Chrome trace in it); None = off
    profile_dir: Optional[str] = None
    # -- not ported: a value other than these raises (see _NOT_PORTED) --
    exec_dir: Optional[str] = None
    exec_local_dir: Optional[str] = None
    exec_max_resident: int = 32
    tp: int = 0
    mesh_audit: bool = False
    cost_ledger: bool = False


def _check_ported(cfg: ServeConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP.md item of every
    field of ``cfg`` that asks for a part of the reference's server the
    port does not have yet (``tp`` 0 and 1 both mean unsharded)."""
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if f.name in _NOT_PORTED and value != f.default and not (f.name == "tp" and value == 1):
            why = f": {_NOT_PORTED_WHY[f.name]}" if f.name in _NOT_PORTED_WHY else ""
            raise NotImplementedError(
                f"ServeConfig.{f.name}={value!r} is not ported to orion_tpu_torch yet "
                f"(ROADMAP.md queue A, {_NOT_PORTED[f.name]}){why}")


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
    # cost-attribution accumulators: each boundary's share is folded in here;
    # _complete stamps the totals onto the DecodeResult
    device_ms: float = 0.0
    cost_flops: float = 0.0
    prefill_tokens: int = 0
    decode_tokens: int = 0
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
        # the weights' identity stamps both stores: prefix entries are keyed
        # by it and session generations carry it (a state resumed under other
        # weights or another qmode would silently diverge)
        self.params_id = cfg.params_id or params_identity(model.cfg, self.qmode)
        self._weights_identity = f"{self.params_id}|{self.qmode}"
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
        self._h_session_save_ms = self.metrics.histogram("session_save_ms")
        self._h_session_load_ms = self.metrics.histogram("session_load_ms")
        self._c_ladder = self.metrics.counter("ladder_rungs")
        self._c_health = self.metrics.counter("health_transitions")
        self._c_slo_alerts = self.metrics.counter("slo_alerts")
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
            on_event=self._on_engine_event, spec_depth=cfg.spec_depth,
            spec_min_accept=cfg.spec_min_accept, device=self.device)
        # speculation: totals, and one acceptance observation a speculating
        # request (its rate collapsing shows before its latency does)
        self._c_spec_accepted = self.metrics.counter("spec_accepted_total")
        self._c_spec_rejected = self.metrics.counter("spec_rejected_total")
        self._c_spec_floors = self.metrics.counter("spec_floor_total")
        self._h_spec_accept = self.metrics.histogram(
            "spec_accept_rate", buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0))
        # the prefix cache: entries aligned on the engine's linear-attention
        # chunk, so a hit's suffix pieces replay the cold request's
        self.prefix_store: Optional[PrefixStore] = None
        self._c_prefix_hits = self.metrics.counter("prefix_hits")
        self._c_prefix_misses = self.metrics.counter("prefix_misses")
        self._c_prefix_publishes = self.metrics.counter("prefix_publishes")
        self._c_prefix_bytes = self.metrics.counter("prefix_bytes")
        self._h_prefix_load_ms = self.metrics.histogram("prefix_load_ms")
        self._h_prefix_save_ms = self.metrics.histogram("prefix_save_ms")
        # storage failure domains: one breaker a store, on the server's
        # clock, each transition into the flight ring
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._c_store_errors = self.metrics.counter("store_errors")
        self._c_prefix_drops = self.metrics.counter("prefix_publish_drops")
        if cfg.prefix_dir:
            self.prefix_store = PrefixStore(
                cfg.prefix_dir, params_id=self.params_id, qmode=self.qmode,
                align=max(self.engine.chunk_align, 1), keep=cfg.prefix_keep,
                should_abort=lambda: not self.health.accepting, observer=self._on_prefix_io,
                clock=clock, breaker=self._make_breaker("prefix"))
            self.engine.attach_prefix_store(self.prefix_store)
        # durable sessions: a write-through disk store with a host-resident
        # LRU cache in front (a resident entry is always on disk too, unless
        # DIRTY, so eviction is cache management and an eviction racing a
        # continuation degrades to a disk read)
        self.session_store: Optional[SessionStore] = None
        if cfg.session_dir:
            self.session_store = SessionStore(
                cfg.session_dir, keep=cfg.session_keep,
                # a draining / dead server must not spend its grace on backoff
                should_abort=lambda: not self.health.accepting, observer=self._on_store_io,
                clock=clock, identity=self._weights_identity,
                breaker=self._make_breaker("session"))
        self._sessions: "OrderedDict[str, SessionState]" = OrderedDict()
        self._session_last_use: Dict[str, float] = {}
        self._active_sessions: set = set()  # ids resident in engine slots
        # ids whose last save FAILED: the resident copy is the only current
        # one, so eviction must not drop them; the tick retries their save
        self._dirty_sessions: set = set()
        self._dirty_retry_at = 0.0
        # the SIGTERM drain's deadline (set on entering DRAINING): a drain
        # with dirty sessions holds them until then, then names them and
        # exits 0
        self._drain_deadline = 0.0
        # gauges evaluated at scrape time from live host state
        self.metrics.gauge_fn("queue_depth", self._q_depth)
        for key in ("active", "free", "prefilling", "decoding"):
            self.metrics.gauge_fn("slots", self._slot_gauge(key), labels={"state": key})
        self.metrics.gauge_fn("sessions_resident", lambda: len(self._sessions))
        self.metrics.gauge_fn("sessions_in_slots", lambda: len(self._active_sessions))
        self.metrics.gauge_fn("dirty_backlog", lambda: len(self._dirty_sessions))
        # cost attribution and capacity: each boundary's measured wall time
        # split over the resident slots, the windowed chunk_ms folded into a
        # tokens/s ceiling and headroom. Host arithmetic over values the
        # scheduler holds; the flops are the analytic 2 x params, counted as
        # the JAX package counts the leaves of its (quantized) parameter tree
        self.cost_enabled = bool(cfg.cost)
        self.cost_ledger: Optional[obs_cost.CostLedger] = None
        self.capacity: Optional[obs_cost.CapacityModel] = None
        if self.cost_enabled:
            tree = expected_params(model.cfg, "" if self.qmode == "off" else self.qmode)
            n_params = sum(int(np.prod(shape)) for _, shape, _ in tree.values())
            self.cost_ledger = obs_cost.CostLedger(
                slots=cfg.slots, chunk=cfg.chunk, prefill_chunk=self.engine.prefill_chunk,
                spec_depth=cfg.spec_depth, fallback_flops_per_token=2.0 * n_params)
            self._h_req_device_ms = self.metrics.histogram("request_device_ms")
            self._h_req_flops = self.metrics.histogram("request_cost_flops",
                                                       buckets=obs_cost.FLOPS_BUCKETS)
            self._c_attr_ms = self.metrics.counter("attributed_ms_total")
            self._c_decode_tokens = self.metrics.counter("decode_tokens_total")
            self._c_prefill_tokens = self.metrics.counter("prefill_tokens_total")
            self.capacity = obs_cost.CapacityModel(
                slots=cfg.slots, chunk=cfg.chunk, buckets=self._h_chunk_ms.buckets,
                read_chunk_counts=self._read_chunk_counts, read_tokens=self._read_device_tokens,
                clock=clock, window_s=cfg.capacity_window_s)
            for field, name in (("ceiling_tokens_per_s", "capacity_tokens_per_s"),
                                ("current_tokens_per_s", "capacity_current_tokens_per_s"),
                                ("headroom", "capacity_headroom")):
                # raises (the cell is absent) until the model has data
                self.metrics.gauge_fn(name, self.capacity.gauge(field))
        # on-demand profiling: armed from any thread (host flags under the
        # stats lock); torch.profiler starts and stops only on the scheduler
        # thread at boundaries
        self._profile_pending = 0
        self._profile_left = 0
        self._profile_path: Optional[str] = None
        self._profile_seq = 0
        self._profiler = None
        self._q: "queue.Queue[Pending]" = queue.Queue(maxsize=cfg.max_inflight)
        self._guard: Optional[PreemptionGuard] = None
        # makes (accepting check -> enqueue) atomic against the drain
        # path's final (reject leftovers -> DEAD): a put landing between the
        # loop's last empty-check and DEAD would strand a Pending
        self._admission_lock = threading.Lock()
        # the SLO loop: windowed views over the same registry cells, ticked at
        # boundaries. tick() reads the cells under the stats lock first and
        # then publishes under the engine's own lock: never both at once
        declared = bool(cfg.slo)  # slo=[] / () declares nothing either
        objectives = ([obs_slo.Objective(**dict(d)) for d in cfg.slo] if declared
                      else obs_slo.default_objectives())
        self.slo = obs_slo.SLOEngine(objectives, obs_slo.registry_readers(self.metrics),
                                     clock=clock)
        self._slo_actuate = declared
        self._slo_burn_ticks = 0
        self._slo_shedding = False
        self._slo_slow_prev = False
        self._chunk_seq = 0  # serve.chunk_delay's step address
        # the live endpoints: up across serve() calls (a balancer must see
        # DRAINING / DEAD as 503, not a refused connection); close() ends them
        self.http: Optional[ObsHTTPServer] = None
        self.http_port: Optional[int] = None
        if cfg.metrics_port >= 0:
            self.http = ObsHTTPServer(
                port=cfg.metrics_port, metrics_fn=self.metrics.snapshot,
                health_fn=self._healthz, statusz_fn=self._statusz, slo_fn=self.slo.state,
                costz_fn=self._costz, profilez_fn=self._profilez)
            self.http_port = self.http.start()

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

    def _on_store_io(self, op: str, ms: float) -> None:
        (self._h_session_save_ms if op == "save" else self._h_session_load_ms).observe(ms)

    def _on_prefix_io(self, op: str, ms: float, nbytes: int) -> None:
        (self._h_prefix_save_ms if op == "save" else self._h_prefix_load_ms).observe(ms)
        self._c_prefix_bytes.inc(nbytes, labels={"op": op})

    # -- storage failure domains -----------------------------------------------

    _BREAKER_GAUGE = {"closed": 0, "half_open": 1, "open": 2}

    def _make_breaker(self, name: str) -> CircuitBreaker:
        """One circuit breaker a store, on the server's clock, registered for
        the health latch, the snapshot and the ``breaker_state`` gauge. Its
        observer runs outside the breaker lock."""
        br = CircuitBreaker(name, consecutive_failures=max(self.cfg.breaker_failures, 1),
                            backoff=self.cfg.breaker_backoff,
                            max_backoff=self.cfg.breaker_max_backoff, clock=self._clock,
                            observer=self._on_breaker)
        self._breakers[name] = br
        self.metrics.gauge_fn("breaker_state", lambda b=br: self._BREAKER_GAUGE[b.state],
                              labels={"store": name})
        return br

    def _on_breaker(self, name: str, old: str, new: str, reason: str) -> None:
        """Breaker transition tap: every edge into the flight ring; a trip
        counts one ``store_errors``."""
        self.flight.record("breaker", store=name, frm=old, to=new, reason=reason)
        if new == "open":
            self._c_store_errors.inc(labels={"store": name})

    def _store_outage(self) -> Optional[str]:
        """The name of a store whose breaker is not known-good (open or
        probing), or None."""
        for name, br in self._breakers.items():
            if br.is_open:
                return name
        return None

    def _store_outage_latched(self) -> bool:
        """Must DEGRADED stay latched for storage? While a breaker is open,
        or while the dirty backlog of a store outage is unsaved: recovery to
        SERVING needs the store back AND every turn it missed on disk."""
        if self._store_outage() is not None:
            return True
        return self.health.reason.startswith("store-outage:") and bool(self._dirty_sessions)

    def _tick_store_health(self) -> None:
        """Chunk-boundary storage health: an open breaker moves SERVING ->
        DEGRADED with reason ``store-outage:<store>`` (a fresh process would
        meet the same dead store: not a reason to respawn); breakers closed
        and the dirty backlog saved recover to SERVING."""
        self._probe_idle_breakers()
        name = self._store_outage()
        if name is not None:
            reason = f"store-outage:{name}"
            self._degrade(reason)
            if (self.health.state is Health.DEGRADED
                    and not self.health.reason.startswith("store-outage:")):
                # DEGRADED already under a blunter reason (the failed save
                # that tripped the breaker): sharpen it
                self.health.restate(reason)
        elif (self.health.state is Health.DEGRADED
              and self.health.reason.startswith("store-outage:")
              and not self._dirty_sessions
              and not self._slo_shedding):
            self.health.to(Health.SERVING, "store recovered; dirty backlog drained")

    def _probe_idle_breakers(self) -> None:
        """Recovery evidence for an outage with no traffic: an open
        breaker's probe normally rides real store work (the dirty-save retry,
        a lookup or a queued publish); a breaker that tripped with none
        pending gets one half-open directory scan per dwell here. Stores
        whose natural probe is pending are skipped."""
        probes = []
        if self.prefix_store is not None and not self.engine.pending_prefix_count:
            probes.append(("prefix", self.prefix_store.list_keys))
        if self.session_store is not None and not self._dirty_sessions:
            probes.append(("session", self.session_store.list_sessions))
        for name, scan in probes:
            br = self._breakers.get(name)
            if br is None or not br.is_open or not br.allow():
                continue
            try:
                scan()
            except OSError as e:
                br.record_failure(f"probe: {type(e).__name__}: {e}")
            else:
                br.record_success()

    # -- the live endpoints' providers (host reads only) ----------------------

    def _healthz(self) -> dict:
        """/healthz: the health snapshot with the HTTP code of its state
        (``health.HTTP_STATUS``) and a one-line status, the reason beside
        any state but serving."""
        snap = self.health.snapshot()
        snap["code"] = HTTP_STATUS[Health(snap["state"])]
        snap["status"] = (snap["state"] if snap["state"] == "serving" or not snap["reason"]
                          else f"{snap['state']}: {snap['reason']}")
        return snap

    def _statusz(self) -> dict:
        """/statusz: the atomic snapshot (health, stats, slots, sessions,
        the failure domains, speculation, SLO) without the registry dump
        (that is /metrics), the cost section and the flight ring's tail."""
        snap = self.snapshot()
        snap.pop("metrics", None)
        if self.cost_enabled:
            flat = self.metrics.counters_flat()
            snap["cost"] = {"capacity": self.capacity.state(),
                            "attributed_ms_total": round(flat.get("attributed_ms_total", 0), 3),
                            "ledger_programs": len(self.cost_ledger.entries())}
        snap["flight_tail"] = self.flight.events()[-20:]
        return snap

    # -- cost attribution and capacity -----------------------------------------

    def _read_chunk_counts(self):
        """CapacityModel reader: chunk_ms's per-bucket counts, every cell
        summed."""
        cell = self._h_chunk_ms.cell_total()
        if cell is None:
            return (0,) * len(self._h_chunk_ms.buckets)
        return tuple(cell["counts"])

    def _read_device_tokens(self):
        """CapacityModel reader: the tokens the boundaries produced so far
        (decode and prefill: both are slot-steps of real work)."""
        flat = self.metrics.counters_flat()
        return flat.get("decode_tokens_total", 0) + flat.get("prefill_tokens_total", 0)

    def _attribute_chunk(self, dt_ms: float) -> None:
        """Split one boundary's measured wall time over its resident slots
        (``obs_cost.attribute_chunk``: the shares sum to ``dt_ms``) and fold
        each share into its request's accumulators. Runs before the
        boundary's finished results complete, so a request's last boundary
        still lands on its result."""
        shares = obs_cost.attribute_chunk(self.cost_ledger, dt_ms, self.engine.last_boundary)
        if not shares:
            return
        d_tokens = p_tokens = 0
        for entry, share_ms, flops in shares:
            d_tokens += entry.get("decode_tokens", 0)
            p_tokens += entry.get("prefill_tokens", 0)
            tag = entry.get("tag")
            if isinstance(tag, Pending):
                tag.device_ms += share_ms
                tag.cost_flops += flops
                tag.decode_tokens += entry.get("decode_tokens", 0)
                tag.prefill_tokens += entry.get("prefill_tokens", 0)
        with self._stats_lock:
            self._c_attr_ms.inc(dt_ms)
            if d_tokens:
                self._c_decode_tokens.inc(d_tokens)
            if p_tokens:
                self._c_prefill_tokens.inc(p_tokens)

    def _tick_cost(self) -> None:
        if self.capacity is not None:
            self.capacity.tick()

    def _costz(self) -> dict:
        """/costz: the program price sheet (empty: no harvest before A13),
        the attribution totals, the capacity state and the profiler's."""
        out: dict = {"enabled": self.cost_enabled}
        if not self.cost_enabled:
            return out
        flat = self.metrics.counters_flat()
        out["ledger"] = self.cost_ledger.entries()
        out["compile_ms"] = self.cost_ledger.compile_times()
        out["attribution"] = {
            "attributed_ms_total": round(flat.get("attributed_ms_total", 0), 3),
            "decode_tokens_total": flat.get("decode_tokens_total", 0),
            "prefill_tokens_total": flat.get("prefill_tokens_total", 0),
            "flops_per_decode_step": self.cost_ledger.flops_per_decode_step(),
            "flops_per_prefill_token": self.cost_ledger.flops_per_prefill_token()}
        if self.cfg.spec_depth:
            out["attribution"]["flops_per_spec_round"] = self.cost_ledger.flops_per_spec_round()
        out["capacity"] = self.capacity.state()
        out["profile"] = {"dir": self.cfg.profile_dir, "pending_chunks": self._profile_pending,
                          "active_chunks_left": self._profile_left,
                          "last_artifact": self._profile_path}
        return out

    # -- on-demand profiling -----------------------------------------------------

    def arm_profile(self, chunks: int) -> dict:
        """Arm a ``torch.profiler`` capture of the next ``chunks``
        boundaries. Only sets host flags (callable from the /profilez
        thread); the profiler starts and stops on the scheduler thread. One
        capture at a time: refused (409) when disabled or already armed or
        running, (400) for a bad count."""
        if not self.cfg.profile_dir:
            return {"error": "profiling disabled: set ServeConfig.profile_dir (--profile-dir)",
                    "code": 409}
        try:
            chunks = int(chunks)
        except (TypeError, ValueError):
            return {"error": f"bad chunks={chunks!r}", "code": 400}
        if chunks <= 0:
            return {"error": f"chunks must be >= 1, got {chunks}", "code": 400}
        with self._stats_lock:
            if self._profile_pending or self._profile_left:
                return {"error": "a profile capture is already armed or active", "code": 409}
            self._profile_pending = chunks
        self.flight.record("profile", event="armed", chunks=chunks)
        return {"armed": chunks, "dir": self.cfg.profile_dir}

    def _profilez(self, params: dict) -> dict:
        # the /profilez provider: flag-setting only (arm_profile parses and
        # refuses)
        return self.arm_profile(params.get("chunks", 8))

    def _profile_maybe_start(self) -> None:
        """Scheduler thread, before the boundary's timed window: take a
        pending arm and start the capture (its start cost is not chunk
        latency; the profiled chunks' overhead lands in chunk_ms)."""
        if not self._profile_pending or self._profile_left:
            return
        with self._stats_lock:
            if not self._profile_pending or self._profile_left:
                return
            chunks, self._profile_pending = self._profile_pending, 0
            # reserved before the profiler starts: a /profilez racing its
            # start still gets its 409
            self._profile_left = chunks
        from orion_tpu_torch.utils.profiling import Capture

        self._profile_seq += 1
        path = os.path.join(self.cfg.profile_dir, f"profile-{self._rid_token}-{self._profile_seq}")
        try:
            self._profiler = Capture(path, cuda=self.device.type == "cuda")
            self._profiler.start()
        except Exception as e:
            self._profiler = None
            with self._stats_lock:
                self._profile_left = 0  # release the reservation
            warnings.warn(f"profiler start failed: {e}", stacklevel=2)
            self.flight.record("profile", event="start_failed", error=type(e).__name__)
            return
        self._profile_path = path
        self.flight.record("profile", event="start", chunks=chunks, dir=path)

    def _profile_maybe_stop(self, force: bool = False) -> None:
        """Scheduler thread, after a boundary (or at the loop's exit with
        ``force``: a capture never outlives the loop that armed it): count
        the boundary down and, at zero, stop and write the trace. The count
        moves under the stats lock; the profiler stops outside it."""
        if not self._profile_left:
            return
        with self._stats_lock:
            if not self._profile_left:
                return
            self._profile_left -= 1
            if self._profile_left > 0 and not force:
                return
            self._profile_left = 0
        prof, self._profiler = self._profiler, None
        try:
            artifact = prof.stop()
        except Exception as e:
            warnings.warn(f"profiler stop failed: {e}", stacklevel=2)
            self.flight.record("profile", event="stop_failed", error=type(e).__name__)
            return
        self.flight.record("profile", event="stop", dir=self._profile_path, artifact=artifact,
                           forced=bool(force), stop_ms=round(prof.stop_ms, 3),
                           export_ms=round(prof.export_ms, 3))

    def _on_health(self, old, new, reason: str) -> None:
        """HealthMachine transition tap (after the machine released the
        shared lock): a flight event and a counter; DEGRADED, DRAINING and
        DEAD dump the flight recorder. Entering DRAINING anchors the drain's
        deadline (a drain holding dirty sessions retries until then)."""
        self.flight.record("health", frm=old.value if old else None, to=new.value,
                           reason=reason)
        self._c_health.inc(labels={"to": new.value})
        if new is Health.DRAINING:
            self._drain_deadline = self._clock() + self.cfg.grace
        if new in (Health.DEGRADED, Health.DRAINING, Health.DEAD):
            self.flight.dump(f"health-{new.value}")

    def _on_engine_event(self, kind: str, fields: dict) -> None:
        """SlotEngine tap (admit, resume, prefill_piece, ladder, evict, the
        prefix events and the speculative rounds and floors): recorded to the
        flight ring with the tag swapped for the request's trace id (a round
        only when it rejected drafts, as ``spec_reject``); ladder rungs
        counted and traced, admissions, prefix hits and floors traced, prefix
        and speculation events counted, a speculating request's acceptance
        observed at its eviction."""
        tag = fields.pop("tag", None)
        rid = getattr(tag, "rid", None)
        if rid is not None:
            fields["req"] = rid
        if kind == "spec_round":
            self._c_spec_accepted.inc(fields.get("accepted", 0))
            self._c_spec_rejected.inc(fields.get("rejected", 0))
            if fields.get("rejected", 0):
                self.flight.record("spec_reject", **fields)
            return
        self.flight.record(kind, **fields)
        if kind == "spec_floor":
            self._c_spec_floors.inc()
            self.trace.instant("spec_floor", id=rid, slot=fields.get("slot"),
                               accept=fields.get("accept_ewma"))
        elif kind == "evict" and fields.get("spec_drafted", 0):
            self._h_spec_accept.observe(fields["spec_accepted"] / fields["spec_drafted"])
        elif kind == "ladder":
            self._c_ladder.inc(labels={"rung": fields.get("rung", "?")})
            self.trace.instant("ladder", id=rid, rung=fields.get("rung"),
                               slot=fields.get("slot"))
        elif kind in ("admit", "resume"):
            self.trace.instant(kind, id=rid, session=fields.get("session"),
                               slot=fields.get("slot"))
        elif kind == "prefix_hit":
            self._c_prefix_hits.inc()
            self.trace.instant("prefix_hit", id=rid, prefix_len=fields.get("prefix_len"),
                               suffix=fields.get("suffix"))
        elif kind == "prefix_miss":
            self._c_prefix_misses.inc()
        elif kind == "prefix_publish":
            self._c_prefix_publishes.inc()
        elif kind == "prefix_drop":
            # the bounded publish queue dropped a novel prefix in an outage:
            # a later cold prefill, never a wrong answer
            self._c_prefix_drops.inc()

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
                # SLO actuation, admission half: while the fast burn lasts the
                # queue bound halves, so a replica missing its objective sheds
                # early and the router fails over to a healthy peer now
                if self._slo_shedding and self._q.qsize() >= max(1, self.cfg.max_inflight // 2):
                    raise queue.Full
                self._q.put_nowait(pending)
            except queue.Full:
                self._bump("shed")
                self.trace.end("queue", pending.rid)
                self.trace.end("request", pending.rid, status="shed")
                why = ("slo fast burn: shedding at half the admission bound" if self._slo_shedding
                       else f"admission queue full ({self.cfg.max_inflight} queued + up to "
                            f"{self.cfg.slots} resident in slots)")
                raise OverloadError(why) from None
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
                    if draining:
                        # sessions do not hold the drain: every resident
                        # session slot is SUSPENDED at this boundary (one
                        # snapshot each, saved before its result is
                        # released); sessionless slots drain to completion
                        for pending, result in self.engine.suspend_sessions():
                            self._complete(pending, result)
                    self._tick_sessions()
                    self._tick_store_health()
                    self._tick_metrics()
                    self._tick_slo()
                    self._tick_cost()
                    self._admit_from_queue(wd)
                    if self.prefix_store is not None and self.engine.has_pending_prefixes:
                        # a declared miss's publish: a solo prefill and a
                        # write, once a novel prefix, off the admission path;
                        # beat first, as admission does
                        if wd is not None:
                            wd.beat("prefix publish")
                        self.engine.publish_pending_prefixes()
                    if not self.engine.busy:
                        if (draining or drain_when_idle) and self._q.empty():
                            if not (draining and self._dirty_sessions
                                    and self._clock() < self._drain_deadline):
                                break
                            # a drain in a store outage: DIRTY sessions are
                            # the only current copy of their conversations;
                            # hold them through the grace window, retrying
                            # their saves on the breaker's probes
                            time.sleep(min(max(cfg.poll, 0.001), 0.05))
                            continue
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
                if self.cfg.profile_dir:
                    # a capture armed mid-drain must not outlive the loop
                    self._profile_maybe_stop(force=True)
                self._guard = None
                # under the admission lock: once DEAD is published no
                # submit can slip a Pending into the dead queue
                with self._admission_lock:
                    self._maybe_drain(guard)
                    if self.health.state is Health.DRAINING:
                        self._reject_leftovers()
                        if self._dirty_sessions:
                            # the grace window ran out with saves still
                            # failing: name the sessions whose last turn
                            # lives only in this process's memory; the drain
                            # itself completed, so the exit stays 0
                            lost = sorted(self._dirty_sessions)
                            self.flight.record("drain_dirty", count=len(lost),
                                               sessions=lost[:16])
                            warnings.warn(
                                f"drain exiting with {len(lost)} dirty session(s) unsaved: "
                                f"{lost[:16]} -- the store outage outlasted the grace window; "
                                "their last turn is lost if this process's memory goes away",
                                stacklevel=2)
                        self.health.to(Health.DEAD, "drained")
                self._tick_metrics(force=True)
                self.trace.flush()
        return 0

    def _tick_slo(self) -> None:
        """Boundary SLO evaluation and actuation. Evaluation always runs
        (the burn rates feed /slo, ``snapshot()["slo"]``, the router's
        tie-break and the supervisor); actuation -- DEGRADED and shedding at
        half the admission bound -- arms only for declared objectives, after
        ``slo_degrade_ticks`` boundaries in a row with a fast burn firing.
        Availability never actuates: its bad events are this server's own
        sheds, and shedding more for them would latch half capacity."""
        st = self.slo.tick()
        firing = [n for n in st["firing_fast"] if st["objectives"][n]["kind"] != "availability"]
        if firing:
            self._slo_burn_ticks += 1
            if self._slo_burn_ticks == 1:  # the rising edge
                self._c_slo_alerts.inc(labels={"alert": "fast"})
                self.flight.record("slo", alert="fast", firing=list(firing),
                                   burn=st["worst_burn_fast"])
        else:
            self._slo_burn_ticks = 0
            if self._slo_shedding:
                self._slo_shedding = False
                self.flight.record("slo", alert="clear")
        slow = bool(st["firing_slow"])
        if slow and not self._slo_slow_prev:
            self._c_slo_alerts.inc(labels={"alert": "slow"})
        self._slo_slow_prev = slow
        if self._slo_actuate and self._slo_burn_ticks >= max(self.cfg.slo_degrade_ticks, 1):
            if not self._slo_shedding:
                self._slo_shedding = True
                self.flight.record("slo", alert="shedding", firing=list(firing))
            self._degrade("slo fast burn: " + ",".join(firing))

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
        queued, go DEAD, and take the live endpoints down (they stay up
        through drains, so a balancer sees 503, not a refused connection)."""
        with self._admission_lock:
            self._reject_leftovers()
            if self.health.state is not Health.DEAD:
                self.health.to(Health.DEAD, "closed")
        if self.http is not None:
            self.http.close()
            self.http = None

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
                self._admit_session(pending, deadline_at)
            else:
                self.engine.admit(pending.request, tag=pending, deadline_at=deadline_at)
        except (OverloadError, StoreUnavailableError) as e:
            # a RETRIABLE shed, not a failure: the session store is down (a
            # session not resident needs a disk read nothing can serve now)
            # or the dirty backlog is at its bound; the conversation's last
            # committed generation is intact, so the caller retries later or
            # on a replica that holds the session resident
            pending.error = e if isinstance(e, OverloadError) else OverloadError(
                f"retriable: {e}")
            self._bump("shed")
            self.flight.record("session_shed", req=pending.rid, why=str(e))
            self._finalize(pending, "shed")
        except Exception as e:
            # request isolation: an unadmittable request is an error RESULT,
            # never a dead process and never a stuck batch (a session whose
            # every generation is corrupt fails here, alone)
            pending.error = e
            self._bump("failed")
            self.flight.record("refused", req=pending.rid, error=type(e).__name__)
            self._degrade(f"request refused: {type(e).__name__}: {e}")
            self._finalize(pending, "error")

    # -- durable sessions ------------------------------------------------------

    def _admit_session(self, pending: Pending, deadline_at) -> None:
        """Route a session turn: resume a suspended session (an O(1) row
        insert; an empty-prompt continuation is bitwise one longer request),
        rebase it when the turn brings new prompt tokens (the whole history
        re-prefilled), or start a new one. Raises into :meth:`_admit`'s
        isolation on anything unadmittable."""
        request = pending.request
        sid = request.session_id
        if self.session_store is None:
            raise ValueError("request carries a session_id but sessions are disabled "
                             "(ServeConfig.session_dir is unset)")
        if self.health.state is Health.DRAINING:
            # a queued session turn starts no work in a drain: it comes back
            # "suspended", untouched, for the restarted server
            self._complete(pending, DecodeResult(tokens=np.zeros((1, 0), np.int64),
                                                 status="suspended", new_tokens=0, chunks=0))
            return
        if sid in self._active_sessions:
            raise ValueError(f"session {sid!r} is already resident in a slot; one turn at a time "
                             "per conversation")
        cap = self.cfg.max_dirty_sessions
        if cap > 0 and sid not in self._dirty_sessions and len(self._dirty_sessions) >= cap:
            # every turn served in an outage is one more DIRTY pin a crash
            # could lose: at the bound, shed instead of growing it (sessions
            # dirty already keep serving)
            raise OverloadError(
                f"session store not accepting writes and the dirty backlog is at its bound "
                f"({cap}): retry on another replica or after the store recovers")
        sess = self._session_lookup(sid)
        if sess is None:  # a new conversation
            self.engine.admit(request, tag=pending, deadline_at=deadline_at, session_id=sid)
            self._active_sessions.add(sid)
            return
        prompt = np.asarray(request.prompt, np.int64).reshape(1, -1)
        want = request.max_new_tokens
        try:
            if prompt.shape[1] > 0:
                # new user tokens: rebase the context (prompt + everything
                # emitted + the new tokens) and re-prefill, the key walk
                # anchored at the carry's fold and the session's seed
                full = np.concatenate([np.asarray(sess.prompt, np.int64),
                                       np.asarray(sess.emitted, np.int64), prompt], axis=1)
                self.engine.admit(dataclasses.replace(request, prompt=full), tag=pending,
                                  deadline_at=deadline_at, session_id=sid,
                                  sample_index=int(sess.emit), seed=int(sess.seed))
            elif sess.buffered >= want:
                # the suspended chunk's overshoot covers this turn: served on
                # the host, no slot, no work on the card
                toks = np.asarray(sess.emitted[:, sess.served:sess.served + want])
                sess.served += want
                self._store_session(sess)
                self._complete(pending, DecodeResult(tokens=toks, status="ok", new_tokens=want,
                                                     chunks=0))
                return
            else:
                self.engine.resume(sess, request, tag=pending, deadline_at=deadline_at)
            self._active_sessions.add(sid)
            self._bump("resumed")
        except Exception:
            # nothing was admitted: the session stays suspended as loaded
            self._cache_session(sess)
            raise

    def _session_lookup(self, sid: str) -> Optional[SessionState]:
        """The resident cache first (popped while the session is in a slot),
        then the newest intact generation on disk. The resident copy is
        trusted only while it is the newest committed generation (another
        replica sharing the store may have saved a later turn); a DIRTY copy
        is newer than anything on disk and stays the truth."""
        sess = self._sessions.pop(sid, None)
        if sess is not None:
            self._session_last_use.pop(sid, None)
            if self.session_store is None or sid in self._dirty_sessions:
                return sess
            try:
                newest = self.session_store.newest_generation(sid)
            except (StoreUnavailableError, OSError):
                # the staleness probe cannot run in an outage: the resident
                # copy is the best one reachable
                return sess
            if sess.generation >= newest:
                return sess
            # stale: another replica advanced the conversation on disk
        if self.session_store is None:
            return None
        try:
            return self.session_store.load(sid)
        except OSError as e:
            # store-shaped: the retriable refusal (_admit sheds it), unlike a
            # corrupt payload's integrity error, which fails the request
            raise StoreUnavailableError("session", f"{type(e).__name__}: {e}") from e

    def _cache_session(self, sess: SessionState) -> None:
        self._sessions[sess.session_id] = sess
        self._sessions.move_to_end(sess.session_id)
        self._session_last_use[sess.session_id] = self._clock()
        cap = max(self.cfg.max_resident_sessions, 1)
        while len(self._sessions) > cap:
            # LRU-evict the oldest CLEAN entry; a dirty one is the only
            # current copy of its conversation and stays pinned
            victim = next((s for s in self._sessions if s not in self._dirty_sessions), None)
            if victim is None:
                break  # everything dirty: hold memory rather than lose turns
            self._sessions.pop(victim, None)
            self._session_last_use.pop(victim, None)

    def _store_session(self, sess: SessionState) -> None:
        """Write-through save and a resident-cache refresh. A failed save
        marks the session DIRTY (pinned resident, retried at boundaries) and
        degrades health; it never raises into the scheduler."""
        self._active_sessions.discard(sess.session_id)
        try:
            if self.session_store is not None:
                self.session_store.save(sess)
                self._bump("session_saves")
            self._dirty_sessions.discard(sess.session_id)
        except StoreUnavailableError:
            # the breaker is open: refused before any syscall; the trip is
            # in the flight ring and the health latch already
            self._dirty_sessions.add(sess.session_id)
        except Exception as e:
            warnings.warn(f"session {sess.session_id} save failed ({type(e).__name__}: {e}); "
                          "keeping the resident copy dirty -- a restart before the next "
                          "successful save loses this turn", stacklevel=2)
            self._c_store_errors.inc(labels={"store": "session"})
            self._dirty_sessions.add(sess.session_id)
            self._degrade(f"session save failed: {type(e).__name__}")
        self._cache_session(sess)

    def _tick_sessions(self) -> None:
        """Chunk-boundary cache upkeep: retry the dirty sessions' saves, and
        drop CLEAN resident entries idle past ``session_idle_s`` (they are on
        disk: eviction frees host memory, never state). The retry rides the
        breaker: while it is open and its probe not due the sweep is one host
        check; when the probe is due the first save IS the probe, and the
        sweep stops at the first refusal. Without a breaker open, at most one
        sweep a second."""
        now = self._clock()
        if self.session_store is not None and self._dirty_sessions:
            br = self.session_store.breaker
            retry_now = now >= self._dirty_retry_at
            if br is not None and br.blocked():
                retry_now = False  # an outage, the probe not due
            elif br is not None and br.is_open:
                retry_now = True  # the probe is due: one save is the probe
            if retry_now:
                self._dirty_retry_at = now + max(1.0, self.cfg.poll)
                for sid in list(self._dirty_sessions):
                    sess = self._sessions.get(sid)
                    if sess is None or sid in self._active_sessions:
                        continue
                    try:
                        self.session_store.save(sess)
                        self._bump("session_saves")
                        self._dirty_sessions.discard(sid)
                    except StoreUnavailableError:
                        break  # the probe failed or was refused: stop now
                    except Exception:
                        continue  # still dirty, still pinned
        idle = self.cfg.session_idle_s
        if idle <= 0 or not self._sessions:
            return
        for sid in list(self._sessions):
            if sid in self._dirty_sessions:
                continue
            if now - self._session_last_use.get(sid, now) > idle:
                self._sessions.pop(sid, None)
                self._session_last_use.pop(sid, None)

    def _step_chunk(self, wd, guard) -> None:
        """One engine boundary: watchdog beat, every slot advanced a chunk,
        the finished completed. The boundary's wall time is one ``chunk_ms``
        observation and, with tracing on, one complete event per resident
        slot (its phase from the engine's host mirrors; the duration is the
        shared batched program's)."""
        if wd is not None:
            wd.beat("decode chunk")
        self._maybe_drain(guard)
        if self.cfg.profile_dir:
            self._profile_maybe_start()
        occupied = self.engine.active_count
        infos = self.engine.slot_info() if self.trace.enabled else ()
        t0 = self._clock()
        finished = self.engine.step()
        self._chunk_seq += 1
        # INSIDE the timed window: injected latency lands in chunk_ms as a
        # slow boundary would
        fire("serve.chunk_delay", step=self._chunk_seq)
        dt = self._clock() - t0
        if self.cfg.profile_dir:
            self._profile_maybe_stop()
        with self._stats_lock:
            self._bump("chunks")
            self._bump("slot_steps_active", occupied)
            self._bump("slot_steps_total", self.engine.slots)
            self._h_chunk_ms.observe(dt * 1e3)
        if self.cost_enabled:
            # before the finished results complete, so a request's last
            # boundary lands on its result; dt * 1e3 is the value chunk_ms
            # observed, so conservation is exact per boundary
            self._attribute_chunk(dt * 1e3)
        for i, tag, phase, k in infos:
            self.trace.complete("decode_chunk" if phase == "decode" else "prefill_piece",
                                t0, dt, req=getattr(tag, "rid", None), slot=i, chunk=k)
        for pending, result in finished:
            self._complete(pending, result)

    def _complete(self, pending: Pending, result: DecodeResult) -> None:
        if result.session is not None:
            # durability before visibility: the session generation is on
            # disk before the caller can see these tokens
            self._store_session(result.session)
        elif pending.request.session_id is not None:
            # a session turn that ended without a snapshot (the ladder
            # exhausted, a forced eviction): release the conversation, so the
            # next turn resumes from the last good generation
            self._active_sessions.discard(pending.request.session_id)
        if self.cost_enabled:
            # the attribution totals onto the result the caller sees
            result.device_ms = round(pending.device_ms, 6)
            result.cost_flops = pending.cost_flops
            result.prefill_tokens = pending.prefill_tokens
            result.decode_tokens = pending.decode_tokens
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
        elif (self.health.state is Health.DEGRADED and not self._slo_shedding
              and not self._store_outage_latched()):
            # the SLO latch holds DEGRADED while the burn lasts (clean but
            # slow completions must not flap it), the storage latch through
            # an outage and its unsaved backlog
            self.health.to(Health.SERVING, "clean request completed")
        self._finalize(pending, result.status)

    def _finalize(self, pending: Pending, status: str) -> None:
        """The one place a Pending's done event fires: stamps done_at,
        observes the turn latency and, with cost on, the request's device ms
        and flops (results only), closes the request's span with its cost,
        releases the waiter and runs ``on_done``."""
        pending.done_at = self._clock()
        cost_args = {}
        if pending.result is not None:
            self._h_turn_ms.observe((pending.done_at - pending.admitted_at) * 1e3)
            if self.cost_enabled:
                self._h_req_device_ms.observe(pending.device_ms)
                self._h_req_flops.observe(pending.cost_flops)
                cost_args = {"device_ms": round(pending.device_ms, 3),
                             "cost_flops": round(pending.cost_flops, 1),
                             "decode_tokens": pending.decode_tokens,
                             "prefill_tokens": pending.prefill_tokens}
        self.trace.end("request", pending.rid, status=status,
                       session=pending.request.session_id, **cost_args)
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
        of the stats lock (the health machine and the registry share it):
        the sessions (resident, in slots, dirty, the resident ids), with a
        store configured the failure domains (each breaker's state and
        probe countdown, the dirty backlog against its bound, the publish
        queue and its drops), and with ``spec_depth`` the speculation (depth,
        floor, the registry's totals, each resident slot's view)."""
        with self._stats_lock:
            snap = self.health.snapshot()
            snap["stats"] = dict(self.stats)
            snap["occupancy"] = self.occupancy_lifetime()
            snap["occupancy_now"] = self.occupancy()
            snap["slots"] = self.engine.occupancy()
            snap["sessions"] = {"resident": len(self._sessions),
                                "in_slots": len(self._active_sessions),
                                "dirty": len(self._dirty_sessions),
                                "resident_ids": list(self._sessions)}
            if self._breakers:
                flat = self.metrics.counters_flat()
                snap["failure_domains"] = {
                    "breakers": {n: b.snapshot() for n, b in self._breakers.items()},
                    "dirty_backlog": len(self._dirty_sessions),
                    "dirty_sessions": sorted(self._dirty_sessions)[:16],
                    "max_dirty_sessions": self.cfg.max_dirty_sessions,
                    "prefix_publish_drops": flat.get("prefix_publish_drops", 0),
                    "pending_prefix_publishes": self.engine.pending_prefix_count}
            if self.cfg.spec_depth:
                flat = self.metrics.counters_flat()
                snap["speculation"] = {
                    "depth": self.cfg.spec_depth, "min_accept": self.cfg.spec_min_accept,
                    "accepted_total": flat.get("spec_accepted_total", 0),
                    "rejected_total": flat.get("spec_rejected_total", 0),
                    "floors_total": flat.get("spec_floor_total", 0),
                    "slots": self.engine.spec_info()}
            snap["queued"] = self._q.qsize()
            # the SLO state and the capacity ride the snapshot, so the fleet
            # acts on them over the status op; state() is the last tick's
            # payload (no reader runs here). "actuate": declared objectives
            snap["slo"] = dict(self.slo.state(), actuate=self._slo_actuate)
            if self.capacity is not None:
                snap["capacity"] = self.capacity.state()
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
