"""Process health state machine for the serving layer: the port's copy of
``orion_tpu/serving/health.py``, whole (it imports no jax).

A serving process is never just "up" or "down": it boots (compiles,
loads params), serves, limps (a request needed the degradation ladder, a
watchdog tripped), drains on SIGTERM (finish in-flight, reject new), and
dies. Load balancers and schedulers need that word, not a log grep — and
the transitions need to be VALIDATED, because the signal path and the
serve loop both drive them concurrently and an illegal edge (a draining
process re-entering service, a dead one accepting work) is exactly the
kind of bug that only fires during an incident.

::

    STARTING ──> SERVING <──> DEGRADED
        │           │             │
        └───────> DRAINING <──────┘
                    │
                    v          (every state may also jump straight
                   DEAD         to DRAINING or DEAD on fatal errors)

DRAINING is absorbing except into DEAD: once a stop was requested there
is no path back to accepting traffic. ``accepting`` is the admission-
control gate — DEGRADED still serves (the ladder recovered the request;
shedding a limping-but-correct replica is the balancer's call, made on
the reported state, not ours).
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, List, Optional, Tuple


class Health(enum.Enum):
    STARTING = "starting"
    SERVING = "serving"
    DEGRADED = "degraded"
    DRAINING = "draining"
    DEAD = "dead"


_ALLOWED = {
    Health.STARTING: {Health.SERVING, Health.DRAINING, Health.DEAD},
    Health.SERVING: {Health.DEGRADED, Health.DRAINING, Health.DEAD},
    Health.DEGRADED: {Health.SERVING, Health.DRAINING, Health.DEAD},
    Health.DRAINING: {Health.DEAD},
    Health.DEAD: set(),
}


class InvalidTransition(RuntimeError):
    """An illegal health edge was requested (e.g. DRAINING -> SERVING)."""


# The documented ``/healthz`` status-code mapping (obs/http.py serves the
# endpoint; the serving layer stamps this code into the payload): load
# balancers speak HTTP status codes, so the CODE answers "send traffic
# here?" while the JSON body says why.
#
#   STARTING -> 503  not ready (compiles / checkpoint load in progress;
#                    submits queue, but a balancer must not target it yet)
#   SERVING  -> 200
#   DEGRADED -> 200  correct but limping: still routable — the router
#                    deprioritizes it on the reported state and burn
#                    rates; shedding it outright is the supervisor's call
#   DRAINING -> 503  finishing in-flight work, accepting nothing new
#   DEAD     -> 503
HTTP_STATUS = {
    Health.STARTING: 503,
    Health.SERVING: 200,
    Health.DEGRADED: 200,
    Health.DRAINING: 503,
    Health.DEAD: 503,
}


class HealthMachine:
    """Validated, thread-safe health transitions with a timestamped
    history (the post-mortem artifact: *when* did we degrade, *what*
    said so)."""

    # a flapping SERVING <-> DEGRADED replica transitions on every ladder
    # engagement; unbounded history would grow the /healthz payload (and
    # host memory) for the lifetime of the process. The last N transitions
    # are the post-mortem-relevant ones; `dropped` says how many scrolled
    # off so a reader knows the log is a suffix.
    HISTORY_LIMIT = 64

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[Health, Health, str], None]] = None,
        history_limit: int = HISTORY_LIMIT,
        lock=None,
    ):
        assert history_limit >= 1, history_limit
        self._clock = clock
        self._on_transition = on_transition
        # ``lock``: an externally-owned RLock shared with the caller's
        # other gauges. The Server passes its stats lock so a fleet
        # router's ``Server.snapshot()`` reads health + occupancy as ONE
        # atomic pair — no transition can interleave between the two
        # reads and hand the router a torn (health, slots) view. Must be
        # reentrant when shared (the snapshot caller holds it already).
        self._lock = lock if lock is not None else threading.Lock()
        self._state = Health.STARTING
        self._reason = "init"
        self._since = clock()
        self._history_limit = int(history_limit)
        self.dropped = 0  # transitions aged out of the bounded history
        self.history: List[Tuple[Optional[Health], Health, str, float]] = [
            (None, Health.STARTING, "init", self._since)
        ]

    @property
    def state(self) -> Health:
        return self._state

    @property
    def reason(self) -> str:
        """Why we entered the CURRENT state (the reason of the last
        transition). Balancers and the fleet supervisor need the why,
        not just the word: a replica DEGRADED for ``store-outage:*``
        must not be respawned (a new process meets the same dead store),
        while one degraded for a wedged engine must."""
        return self._reason

    @property
    def accepting(self) -> bool:
        """May new requests be admitted? DEGRADED still serves; STARTING
        queues work for the serve loop to pick up once ready."""
        return self._state in (Health.STARTING, Health.SERVING, Health.DEGRADED)

    def to(self, new: Health, reason: str = "") -> bool:
        """Transition to ``new``; returns False for an idempotent
        same-state request, raises :class:`InvalidTransition` on an
        illegal edge. The reason string is recorded — transitions without
        a why are useless in a post-mortem."""
        with self._lock:
            old = self._state
            if new is old:
                return False
            if new not in _ALLOWED[old]:
                raise InvalidTransition(
                    f"health: illegal transition {old.value} -> {new.value}"
                    f" ({reason or 'no reason given'})"
                )
            self._state = new
            self._reason = reason
            self._since = self._clock()
            self.history.append((old, new, reason, self._since))
            if len(self.history) > self._history_limit:
                drop = len(self.history) - self._history_limit
                del self.history[:drop]
                self.dropped += drop
        if self._on_transition is not None:
            self._on_transition(old, new, reason)
        return True

    def restate(self, reason: str) -> bool:
        """Re-reason the CURRENT state without a transition. The cause of
        a sticky state can sharpen after entry — a save failure degrades
        with a generic reason, then the circuit breaker trips and the
        same episode is recognized as a store outage — and the consumers
        of ``reason`` (the supervisor's respawn suppression, /healthz's
        status line) act on the sharper why. Recorded in the bounded
        history as an ``old == new`` edge and reported to
        ``on_transition`` like any transition; ``_since`` is untouched
        (the state itself did not change). No-op if the reason already
        matches."""
        with self._lock:
            if reason == self._reason:
                return False
            state = self._state
            self._reason = reason
            self.history.append((state, state, reason, self._clock()))
            if len(self.history) > self._history_limit:
                drop = len(self.history) - self._history_limit
                del self.history[:drop]
                self.dropped += drop
        if self._on_transition is not None:
            self._on_transition(state, state, reason)
        return True

    def snapshot(self) -> dict:
        """The /healthz payload: current state, how long we've been in
        it, and the last ``history_limit`` transitions (``dropped``
        counts the ones that aged out — the payload stays bounded on a
        flapping long-lived replica)."""
        with self._lock:
            return {
                "state": self._state.value,
                "reason": self._reason,
                "accepting": self.accepting,
                "in_state_secs": self._clock() - self._since,
                "dropped": self.dropped,
                "transitions": [
                    {
                        "from": a.value if a else None,
                        "to": b.value,
                        "reason": r,
                        "at": t,
                    }
                    for a, b, r, t in self.history
                ],
            }


__all__ = ["Health", "HealthMachine", "InvalidTransition", "HTTP_STATUS"]
