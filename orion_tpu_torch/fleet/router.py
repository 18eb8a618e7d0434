"""Admission-aware least-loaded dispatch over N replicas: the port's copy
of ``orion_tpu/fleet/router.py``.

The router is the fleet's front door: one ``submit()`` that places a
request on the best live replica and returns that replica's pending
handle. "Best" is deliberately simple — the O(1)-state engine makes every
replica equally able to serve every request (sessions live on shared
disk, migration is a read), so placement is pure load balancing:

- **least-loaded, latency-aware** — candidates sort by (health rank,
  in-flight count, SLO penalty, index): SERVING/STARTING replicas before
  DEGRADED ones (a limping replica still serves correctly, the ladder's
  contract, but it only gets work when every healthy peer is busier),
  DRAINING/DEAD replicas are never candidates; equally-healthy,
  equally-loaded replicas tie-break on (fast-burn firing, windowed p99)
  from their last status snapshot, so traffic shifts away from a slow
  replica BEFORE it leaves SERVING. In-flight counts are router-side
  (incremented at dispatch, decremented at result) so dispatch needs no
  status round-trip on the hot path; the SLO penalty reads the snapshot
  the supervisor's heartbeat already refreshes.
- **bounded fleet admission** — ``max_inflight`` bounds the TOTAL
  in-flight work across the fleet; beyond it ``submit`` sheds with
  :class:`~orion_tpu_torch.serving.server.OverloadError` — the single
  server's contract, one level up. Per-replica sheds
  (a full admission queue) fail over to the next candidate; only a fleet
  with nowhere left to put the request raises.
- **failover** — a dispatch that dies on the wire (control channel broke,
  replica just exited, an injected ``fleet.dispatch``/``fleet.control_io``
  fault) moves to the next candidate; the request only fails when every
  routable replica refused. The supervisor notices the broken replica on
  its next heartbeat and respawns it — the router never blocks on that.
- **session serialization** — one turn at a time per conversation,
  FLEET-wide: the router remembers the pending of each session's last
  turn and refuses a new one until it resolved. (Per-replica servers
  enforce this locally; with shared-store mobility the fleet needs the
  same fence globally, or two replicas could both resume generation N.)

``fire("fleet.dispatch", step=ordinal)`` runs before each placement
attempt — the chaos address for dispatch-path faults.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from orion_tpu_torch.obs.trace import Tracer
from orion_tpu_torch.resilience.inject import fire
from orion_tpu_torch.serving.server import OverloadError, RejectedError
from orion_tpu_torch.serving.session import DecodeRequest

from orion_tpu_torch.fleet.replica import FleetPending, ReplicaGone, ReplicaHandle

_HEALTH_RANK = {"starting": 0, "serving": 0, "degraded": 1}


class Router:
    """Thread-safe dispatcher over a (mutable) replica list. The
    supervisor owns the list and swaps respawned replicas in under
    :meth:`replace`; submitters may call :meth:`submit` from any thread."""

    def __init__(
        self,
        replicas: List[ReplicaHandle],
        max_inflight: int = 0,
        clock: Callable[[], float] = time.monotonic,
        tracer: Optional[Tracer] = None,
    ):
        self.replicas = list(replicas)
        self.max_inflight = int(max_inflight)  # 0 = unbounded fleet queue
        self._clock = clock
        # the fleet's root spans: the router opens one ``turn`` span per
        # dispatched request (id = the session id + turn ordinal when
        # there is one), closed when the pending resolves — so a
        # conversation that migrates across replicas is ONE connected
        # trace once the per-replica files are merged
        self.trace = tracer if tracer is not None else Tracer(
            path=None, clock=clock, enabled=False,
        )
        self._lock = threading.RLock()
        self._active_sessions: Dict[str, object] = {}  # sid -> pending
        self._dispatches = 0  # fleet.dispatch's step address
        self._dispatching = 0  # submits between admission check and wire ack
        self._turn_seq = 0  # root-span ordinal (trace ids stay unique)
        self.stats: Dict[str, int] = {
            "dispatched": 0, "shed": 0, "rejected": 0, "failovers": 0,
        }

    # -- replica-set maintenance ----------------------------------------------

    def replace(self, old: ReplicaHandle, new: ReplicaHandle) -> None:
        with self._lock:
            for i, r in enumerate(self.replicas):
                if r is old:
                    self.replicas[i] = new
                    return
            self.replicas.append(new)

    def add(self, new: ReplicaHandle) -> None:
        """Grow the fleet by one replica (autoscale scale-out): the
        handle joins the candidate set atomically — the next ``submit``
        may already place work on it."""
        with self._lock:
            self.replicas.append(new)

    def remove(self, old: ReplicaHandle) -> None:
        """Shrink the fleet (autoscale scale-in): drop ``old`` from the
        candidate set. The caller drains it AFTERWARD — removal first
        means no new dispatch can race onto a replica that is about to
        suspend its sessions; work already in flight on it resolves
        through its own pending handles, untouched by the roster."""
        with self._lock:
            self.replicas[:] = [r for r in self.replicas if r is not old]

    def _candidates(self, session_id: Optional[str] = None) -> List[Tuple]:
        """Routable replicas, best-first: (affinity, health rank,
        inflight, slo penalty, index). DRAINING/DEAD/dead-process
        replicas never appear.

        The AFFINITY term engages only during a store
        outage: a replica DEGRADED with reason ``store-outage:*`` that
        holds ``session_id`` RESIDENT (its last status snapshot lists
        the id) sorts before every other candidate, healthy ones
        included — during the outage it is the only replica that can
        serve the turn at all (everyone else needs the dead store for
        the session load and sheds), and its write-behind copy is the
        only up-to-date one. Outside an outage the term is 0 everywhere
        and placement is pure load balancing as before. Store-outage
        replicas WITHOUT the session stay deprioritized by the health
        rank but remain routable (cold prefix misses still serve).

        The SLO penalty — ``(fast-burn firing?, windowed p99 ms)`` from
        each replica's last status snapshot — is the LATENCY-AWARE
        tie-break: two equally-healthy, equally-loaded replicas resolve
        toward the one whose recent window is faster, so traffic shifts
        away from a slow replica BEFORE its burn degrades it out of the
        health rank. It deliberately sorts after inflight: a slow idle
        replica still beats a fast saturated one (queueing behind work
        is worse than a slow scan), and the penalty can never starve a
        replica the fleet actually needs for capacity.

        Health rank and SLO penalty are read OUTSIDE the router lock:
        both walk replica-side state (the handle's health machine, its
        last status snapshot) and the router lock is strict-scope —
        bookkeeping only, never foreign code. Only the replica-list
        snapshot itself is taken under the lock; a replica that drains
        after the snapshot is caught by submit's failover path exactly
        like one that drains after the pick."""
        with self._lock:
            replicas = list(self.replicas)
        out = []
        for i, r in enumerate(replicas):
            if not r.routable:
                continue
            state = r.health_state()
            rank = _HEALTH_RANK.get(state)
            if rank is None:
                continue
            affinity = 0
            if session_id is not None and state == "degraded":
                status = getattr(r, "last_status", None) or {}
                if str(status.get("reason") or "").startswith(
                        "store-outage:"):
                    resident = (
                        (status.get("sessions") or {}).get("resident_ids")
                        or ()
                    )
                    if session_id in resident:
                        affinity = -1
            out.append((affinity, rank, r.inflight, r.slo_penalty(), i, r))
        out.sort(key=lambda t: t[:5])
        return out

    # -- dispatch -------------------------------------------------------------

    def submit(self, request: DecodeRequest):
        """Place ``request`` on the least-loaded routable replica and
        return its pending handle. Raises OverloadError when the fleet's
        admission bound is hit (or every replica shed), RejectedError
        when no replica is routable at all, ValueError for a busy
        session — always loudly, never a silent drop.

        The router lock covers only the BOOKKEEPING (session fence,
        admission count, candidate pick) — never the wire round-trip to
        a replica, which can block for seconds on a wedged child. One
        slow replica must not stall every other submitter, the gauges,
        or the supervisor's healing path. The session fence therefore
        RESERVES the conversation under the lock before dispatching
        (a placeholder pending other submitters see as in-flight) and
        swaps the real pending in — or releases the reservation — once
        the wire settles."""
        sid = request.session_id
        reservation = None
        # built ahead of the lock: the Event is the reservation's done
        # flag and the candidate scan reads replica-side health state —
        # neither belongs in the strict-scope bookkeeping section
        turn_done = threading.Event() if sid is not None else None
        candidates = self._candidates(sid)
        with self._lock:
            if self._dispatches % 256 == 0:
                # amortized sweep: a conversation that never returns
                # must not pin its last pending (and result tokens)
                # in the session fence forever
                self._active_sessions = {
                    s: p for s, p in self._active_sessions.items()
                    if not p.done.is_set()
                }
            if sid is not None:
                prev = self._active_sessions.get(sid)
                if prev is not None and not prev.done.is_set():
                    raise ValueError(
                        f"session {sid!r} already has a turn in flight on "
                        "this fleet; one turn at a time per conversation"
                    )
            if self.max_inflight > 0:
                total = (
                    sum(r.inflight for r in self.replicas if r.alive)
                    + self._dispatching
                )
                if total >= self.max_inflight:
                    self.stats["shed"] += 1
                    raise OverloadError(
                        f"fleet admission full ({total} in flight >= "
                        f"max_inflight {self.max_inflight})"
                    )
            if not candidates:
                self.stats["rejected"] += 1
                raise RejectedError("no routable replica in the fleet")
            self._dispatching += 1
            if sid is not None:
                reservation = FleetPending(session_id=sid, done=turn_done)
                self._active_sessions[sid] = reservation
            self._turn_seq += 1
            tid = (f"{sid}:{self._turn_seq}" if sid is not None
                   else f"turn-{self._turn_seq}")
        # the fleet-level root span: opened BEFORE placement, closed when
        # the pending resolves (or right here if nothing could take it) —
        # merged with the replicas' trace files this connects a turn's
        # whole story across processes, keyed by the session id in args
        self.trace.begin("turn", tid, cat="fleet", session=sid)
        placed = False
        failures = []
        overloads = 0
        owed = True  # does _dispatching still carry this request?
        try:
            for *_, replica in candidates:
                with self._lock:
                    self._dispatches += 1
                    step = self._dispatches
                try:
                    fire("fleet.dispatch", step=step)
                    # hand the admission count over to the replica's own
                    # inflight gauge (incremented at submit entry):
                    # keeping _dispatching elevated too would DOUBLE-
                    # count this request against max_inflight for the
                    # whole ack round-trip and shed below capacity
                    with self._lock:
                        self._dispatching -= 1
                    owed = False
                    try:
                        pending = replica.submit(request)
                    except BaseException:
                        with self._lock:
                            self._dispatching += 1
                        owed = True
                        raise
                except OverloadError as e:
                    overloads += 1
                    failures.append((replica.name, e))
                    continue
                except (ReplicaGone, OSError, RejectedError) as e:
                    # wire-level failure, or the replica started draining
                    # between the routable check and the submit: fail
                    # over, let the supervisor's heartbeat find the corpse
                    with self._lock:
                        self.stats["failovers"] += 1
                    failures.append((replica.name, e))
                    continue
                with self._lock:
                    self.stats["dispatched"] += 1
                    if sid is not None:
                        self._active_sessions[sid] = pending
                        reservation = None
                self.trace.instant("dispatched", cat="fleet", id=tid,
                                   replica=replica.name)
                self._attach_turn_close(pending, tid)
                placed = True
                return pending
            with self._lock:
                if overloads:
                    # ANY replica merely shedding means capacity exists
                    # and will free up — classify the round as overload
                    # (retryable), never as a permanent-looking reject
                    self.stats["shed"] += 1
                    raise OverloadError(
                        ("every routable replica shed the request: "
                         if overloads == len(failures)
                         else "no capacity on any routable replica: ")
                        + "; ".join(f"{n}: {e}" for n, e in failures)
                    )
                self.stats["rejected"] += 1
            raise RejectedError(
                "dispatch failed on every routable replica: "
                + "; ".join(f"{n}: {type(e).__name__}" for n, e in failures)
            )
        finally:
            if not placed:
                # nothing took the request: the root span still pairs
                self.trace.end("turn", tid, cat="fleet", status="unplaced")
            with self._lock:
                if owed:
                    self._dispatching -= 1
                if reservation is not None and (
                    self._active_sessions.get(sid) is reservation
                ):
                    del self._active_sessions[sid]

    def _attach_turn_close(self, pending, tid: str) -> None:
        """Close the root ``turn`` span EXACTLY once when ``pending``
        resolves. ``on_done`` may already have missed the resolution (a
        fast replica can finish between submit and here), so a
        done-already pending closes immediately; a non-blocking
        once-lock arbitrates the race — exactly one of the two possible
        callers wins it, so the span can neither double-close nor leak
        unclosed."""
        once = threading.Lock()

        def _close(p) -> None:
            if not once.acquire(blocking=False):
                return
            err = getattr(p, "error", None)
            result = getattr(p, "result", None)
            status = (
                f"error:{type(err).__name__}" if err is not None
                else (result.status if result is not None else "?")
            )
            self.trace.end("turn", tid, cat="fleet", status=status,
                           replica=getattr(p, "replica", ""))

        pending.on_done = _close
        if pending.done.is_set():
            _close(pending)

    # -- observability --------------------------------------------------------

    def inflight(self) -> int:
        with self._lock:
            return sum(r.inflight for r in self.replicas if r.alive)

    def snapshot(self) -> dict:
        """Fleet-level gauge payload: per-replica liveness/health/load
        plus the router's own counters.

        The router's own bookkeeping (counters, session fence, replica
        list) is ONE atomic read under the lock; per-replica health is
        then read outside it — ``health_state()`` is replica-side code
        and the router lock is strict-scope. The rows are therefore a
        consistent fleet roster with per-replica fields that may each
        be a beat newer, which is what a gauge scrape wants anyway."""
        with self._lock:
            replicas = list(self.replicas)
            active = sum(
                1 for p in self._active_sessions.values()
                if not p.done.is_set()
            )
            stats = dict(self.stats)
        return {
            "replicas": [
                {
                    "name": r.name,
                    "alive": r.alive,
                    "state": r.health_state(),
                    "inflight": r.inflight,
                }
                for r in replicas
            ],
            "inflight": sum(r.inflight for r in replicas if r.alive),
            "max_inflight": self.max_inflight,
            "active_sessions": active,
            "stats": stats,
        }


__all__ = ["Router"]
