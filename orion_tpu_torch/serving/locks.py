"""Declared lock hierarchy of the port's threaded serving stack: the port's
counterpart of ``orion_tpu/serving/locks.py``, declaring only the locks the
port has.

It is data. Every lock of the port's ``serving/``, ``fleet/``, ``obs/`` and
``resilience/`` modules is declared here with

- its **site** (module / class-or-function scope / attribute name) and any
  **aliases** -- other sites that hold *the same object* (the Server injects
  its stats RLock into HealthMachine and MetricsRegistry, so all three are
  ONE node of the hierarchy);
- the partial acquisition **ORDER** over nodes (outer before inner);
- the fields it **guards** (written only while held; ``__init__`` and
  module-level construction are exempt by declaration).

This module imports none of the modules it declares. ``tests/test_torch_obs.py``
checks every declared site and guarded field against an attribute assignment
in its module (an AST walk), every alias against a real site, and ORDER for
cycles. The auditor that walks held scopes (the reference's
``analysis/concurrency_audit.py``, with its per-lock call bans) comes with
ROADMAP.md A13.

Lock-free by design, declared by omission:

- ``Tracer._emit`` appends to its deque without the tracer lock
  (``deque.append`` is atomic under the GIL, and the emit path runs once per
  slot per boundary); only the snapshot takes ``obs.trace``.
- ``FlightRecorder.record_signal_safe`` skips the ring lock (a signal handler
  that blocks on a lock the interrupted code holds deadlocks at preemption
  time) and skips the ``dropped`` counter rather than race it.
- ``SlotEngine`` takes no lock: the Server's scheduler thread is its only
  caller (thread confinement); ``submit`` hands requests over through the
  thread-safe queue.
- ``inject._active`` (the armed plan) is swapped by the ``inject`` context
  manager on the test's thread; a plan's own state is under ``inject.plan``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

__all__ = ["GuardedField", "LockDecl", "LockSite", "LOCKS", "ORDER"]


@dataclass(frozen=True)
class LockSite:
    """Where a lock object lives: ``module`` is the repo-relative path of the
    declaring module, ``scope`` the class (or, for function-local locks, the
    function) that owns it ('' = module level), ``attr`` the attribute /
    variable name bound to the lock object."""

    module: str
    scope: str
    attr: str


@dataclass(frozen=True)
class GuardedField:
    """A field that must only be WRITTEN while the declaring lock is held:
    (module, scope, field) over attribute-assignment targets."""

    module: str
    scope: str
    fields: Tuple[str, ...]
    note: str = ""


@dataclass(frozen=True)
class LockDecl:
    name: str
    site: LockSite
    kind: str  # "Lock" | "RLock"
    note: str
    aliases: Tuple[LockSite, ...] = ()
    guards: Tuple[GuardedField, ...] = ()
    # method names whose writes are construction-path exempt
    guard_exempt: Tuple[str, ...] = ("__init__",)


_SERVER = "orion_tpu_torch/serving/server.py"
_HEALTH = "orion_tpu_torch/serving/health.py"
_ROUTER = "orion_tpu_torch/fleet/router.py"
_REPLICA = "orion_tpu_torch/fleet/replica.py"
_METRICS = "orion_tpu_torch/obs/metrics.py"
_TRACE = "orion_tpu_torch/obs/trace.py"
_SLO = "orion_tpu_torch/obs/slo.py"
_COST = "orion_tpu_torch/obs/cost.py"
_FLIGHT = "orion_tpu_torch/obs/flight.py"
_WATCHDOG = "orion_tpu_torch/resilience/watchdog.py"
_INJECT = "orion_tpu_torch/resilience/inject.py"
_BREAKER = "orion_tpu_torch/resilience/breaker.py"

LOCKS: Dict[str, LockDecl] = {
    decl.name: decl
    for decl in [
        LockDecl(
            name="server.stats",
            site=LockSite(_SERVER, "Server", "_stats_lock"),
            kind="RLock",
            note="the Server's metrics / health / profiling lock. Reentrant and "
            "SHARED: the Server injects it into HealthMachine and MetricsRegistry "
            "(lock= kwarg) so Server.snapshot() reads health + gauges as one "
            "atomic pair. Standalone instances construct their own.",
            aliases=(
                LockSite(_HEALTH, "HealthMachine", "_lock"),
                LockSite(_METRICS, "MetricsRegistry", "_lock"),
            ),
            guards=(
                GuardedField(
                    _SERVER, "Server", ("_profile_pending", "_profile_left"),
                    note="the /profilez arm handshake: a scrape thread arms, the "
                    "scheduler consumes; 'one capture at a time' (the 409) is these "
                    "two fields read-modify-written under one lock"),
                GuardedField(
                    _HEALTH, "HealthMachine", ("_state", "_since", "dropped"),
                    note="the signal path (via the loop) and the watchdog "
                    "thread both drive transitions"),
                GuardedField(
                    _METRICS, "MetricsRegistry", ("_counters", "_gauges", "_hists"),
                    note="cell mutation from any thread"),
            ),
        ),
        LockDecl(
            name="server.admission",
            site=LockSite(_SERVER, "Server", "_admission_lock"),
            kind="Lock",
            note="serializes submit()'s accept / reject decision against the "
            "drain: health gate, rid sequencing, root-span begin and the "
            "queue put are one atomic admission. Nests OUTSIDE server.stats "
            "(serve()'s drain path moves health while holding it).",
            guards=(
                GuardedField(_SERVER, "Server", ("_rid_seq",),
                             note="request ids unique across submit threads"),
            ),
        ),
        # -- fleet --------------------------------------------------------------
        LockDecl(
            name="router.lock",
            site=LockSite(_ROUTER, "Router", "_lock"),
            kind="RLock",
            note="the fleet's outermost lock: session fence, admission count, "
            "dispatch counters. Bookkeeping only: never the wire round-trip and "
            "never a replica-handle method (a wedged child must not stall other "
            "submitters, the gauges or the supervisor).",
            guards=(
                GuardedField(
                    _ROUTER, "Router",
                    ("_active_sessions", "_dispatches", "_dispatching", "_turn_seq", "stats",
                     "replicas"),
                    note="all router state; submitter threads and the supervisor's "
                    "replace() race on it"),
            ),
        ),
        LockDecl(
            name="router.turn_once",
            site=LockSite(_ROUTER, "Router", "once"),
            kind="Lock",
            note="a turn's close arbitration (local to _attach_turn_close): a "
            "non-blocking try-acquire never released, so exactly one of the two "
            "closers (on_done, or the already-done path) ends the root span.",
        ),
        LockDecl(
            name="replica.send",
            site=LockSite(_REPLICA, "ProcessReplica", "_send_lock"),
            kind="Lock",
            note="serializes writes to the child's stdin pipe: wire I/O under it "
            "is its purpose (interleaved partial lines would corrupt the channel).",
        ),
        LockDecl(
            name="replica.state",
            site=LockSite(_REPLICA, "ProcessReplica", "_state_lock"),
            kind="Lock",
            note="request bookkeeping (pending map, reply routing, inflight count, "
            "id sequence); the wire round-trip happens outside it.",
            guards=(
                GuardedField(_REPLICA, "ProcessReplica", ("_pendings", "_replies", "_next_id"),
                             note="submit threads and the reader thread race on these"),
            ),
        ),
        LockDecl(
            name="replica.local",
            site=LockSite(_REPLICA, "LocalReplica", "_lock"),
            kind="Lock",
            note="an in-process replica's outstanding-request ledger.",
            guards=(
                GuardedField(_REPLICA, "LocalReplica", ("_outstanding",),
                             note="submitters and completions race on it"),
            ),
        ),
        LockDecl(
            name="replica.child_out",
            site=LockSite(_REPLICA, "_child_main", "out_lock"),
            kind="Lock",
            note="child side: serializes result and reply lines onto the one "
            "stdout pipe (replica.send's mirror image).",
        ),
        # -- obs ----------------------------------------------------------------
        LockDecl(
            name="obs.slo",
            site=LockSite(_SLO, "SLOEngine", "_lock"),
            kind="Lock",
            note="publishes tick()'s payload for cheap state() reads. tick() runs "
            "its readers first, then takes this lock. Nests INSIDE server.stats "
            "(Server.snapshot() calls slo.state() holding it).",
            guards=(
                GuardedField(_SLO, "SLOEngine", ("_state",),
                             note="the published payload; scrapes read it under the lock"),
            ),
        ),
        LockDecl(
            name="obs.cost.ledger",
            site=LockSite(_COST, "CostLedger", "_lock"),
            kind="Lock",
            note="program-cost entries and compile-time observations; read by "
            "/costz scrapes.",
        ),
        LockDecl(
            name="obs.cost.capacity",
            site=LockSite(_COST, "CapacityModel", "_lock"),
            kind="Lock",
            note="the capacity state: tick() reads its counters before the lock "
            "(slo.tick's shape) and publishes under it. Nests INSIDE "
            "server.stats (Server.snapshot() reads the state holding it).",
            guards=(GuardedField(_COST, "CapacityModel", ("_state",)),),
        ),
        LockDecl(
            name="obs.trace",
            site=LockSite(_TRACE, "Tracer", "_lock"),
            kind="Lock",
            note="snapshot arbitration only; the emit hot path is lock-free.",
        ),
        LockDecl(
            name="obs.flight",
            site=LockSite(_FLIGHT, "FlightRecorder", "_lock"),
            kind="Lock",
            note="ring append / snapshot; dump() snapshots under it and "
            "writes the file outside it.",
            guards=(
                GuardedField(_FLIGHT, "FlightRecorder", ("dropped", "_seq"),
                             note="record_signal_safe skips dropped by design"),
            ),
            guard_exempt=("__init__", "record_signal_safe"),
        ),
        LockDecl(
            name="obs.flight.default",
            site=LockSite(_FLIGHT, "", "_default_lock"),
            kind="Lock",
            note="guards swaps of the module-default recorder in configure().",
            guards=(GuardedField(_FLIGHT, "", ("_default",)),),
        ),
        LockDecl(
            name="watchdog.lock",
            site=LockSite(_WATCHDOG, "Watchdog", "_lock"),
            kind="Lock",
            note="heartbeat bookkeeping only; the diagnosis and every "
            "callback run after release.",
            guards=(
                GuardedField(
                    _WATCHDOG, "Watchdog",
                    ("_last", "_beats", "_tripped", "_trip_at", "trip_attempt", "_armed",
                     "_label"),
                    note="the monitor thread and the beating owner race on "
                    "the heartbeat window"),
            ),
        ),
        LockDecl(
            name="breaker.lock",
            site=LockSite(_BREAKER, "CircuitBreaker", "_lock"),
            kind="Lock",
            note="a store's circuit breaker: state, window and probe bookkeeping "
            "only. It sits on every store syscall's fast path (blocked() in each "
            "_io_* helper) and on the scheduler's per-boundary outage check, so "
            "its held scope is one branch and a clock read; transition "
            "observers (flight ring, metrics, the health latch) run after "
            "release, and store I/O never runs under it.",
            guards=(
                GuardedField(
                    _BREAKER, "CircuitBreaker",
                    ("_state", "_consec", "_trips", "_probe_at", "_opened_at",
                     "_open_count", "_last_reason"),
                    note="operations on any thread sample the breaker"),
            ),
        ),
        LockDecl(
            name="inject.plan",
            site=LockSite(_INJECT, "FaultPlan", "_lock"),
            kind="Lock",
            note="fault matching / consumption only; delivery observers and "
            "the fault's action run after release.",
        ),
    ]
}


# (outer, inner): `outer` may be held while acquiring `inner`. Pairs not
# listed are unordered.
ORDER: Tuple[Tuple[str, str], ...] = (
    # serve()'s drain path moves health (stats lock) while holding the
    # admission lock; submit()'s counter bumps do the same
    ("server.admission", "server.stats"),
    # Server.snapshot() reads the SLO and capacity states holding the stats
    # lock; their ticks never take the stats lock while holding their own
    ("server.stats", "obs.slo"),
    ("server.stats", "obs.cost.capacity"),
    # the router lock is the fleet's outermost: replica-internal locks (the
    # inflight gauges) may be read below it, never above it
    ("router.lock", "replica.state"),
    ("router.lock", "replica.local"),
    # flight.record from code holding the stats lock is legal; a flight path
    # taking the stats lock back is not
    ("server.stats", "obs.flight"),
    # a metrics scrape evaluates the breaker_state gauge (which reads the
    # breaker's state under its lock) while holding the registry lock; the
    # reverse never happens: breaker observers run after release
    ("server.stats", "breaker.lock"),
)


def _validate() -> None:
    names = set(LOCKS)
    for outer, inner in ORDER:
        if outer not in names or inner not in names or outer == inner:
            raise ValueError(f"bad ORDER pair {(outer, inner)}")
    for decl in LOCKS.values():
        if decl.kind not in ("Lock", "RLock"):
            raise ValueError(f"{decl.name}: kind {decl.kind!r}")
    succ: Dict[str, set] = {}
    for outer, inner in ORDER:
        succ.setdefault(outer, set()).add(inner)
    done: set = set()

    def walk(n: str, stack: Tuple[str, ...]) -> None:
        if n in stack:
            raise ValueError(f"ORDER cycle through {n}")
        if n in done:
            return
        for m in succ.get(n, ()):
            walk(m, stack + (n,))
        done.add(n)

    for n in list(succ):
        walk(n, ())


_validate()
