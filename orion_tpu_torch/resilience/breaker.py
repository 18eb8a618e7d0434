"""Circuit breaker: fail-fast admission control for shared-store I/O (the
port's copy of ``orion_tpu/resilience/breaker.py``, whole: it imports no
jax).

The fault model in :mod:`orion_tpu_torch.resilience.inject` can express a
store that is *down for thirty seconds* (``FaultPlan.degrade_site``), and
the retry layer (:mod:`orion_tpu_torch.resilience.retry`) is the wrong tool
against it: every boundary would pay full jittered backoff on the scheduler
thread, per operation, for the whole outage. The breaker is the
complement: after a few *completed-operation* failures it opens and every
subsequent gated operation fails in O(1) host work (one lock, one clock
read, **no disk syscalls**) until a jittered backoff expires, at which point
exactly ONE probe operation is let through (half-open). A probe success
closes the breaker and resets the backoff; a probe failure re-opens it with
the backoff doubled.

State machine::

      closed --(consecutive failures >= threshold, or windowed
     ^      |    failure rate >= rate with >= min_samples)--> open
     |      |                                                  | ^
     |      +------------ success just records                 | |
     |                                                 (backoff, | |
     |                                                  jittered)| |
     +--(probe succeeds)-- half_open <-------------------------+ |
                               +---(probe fails: backoff *= 2)---+

Granularity is the completed operation, not the raw syscall: one ``save()``
(retries included) is one sample, so the thresholds speak the language of
the logs ("three saves in a row failed") and one operation's internal
retry burst cannot trip the breaker alone.

Everything time-shaped is injectable (``clock``; the jitter is seeded from
the breaker's name, as retry.py seeds from ``describe``), so tests walk the
state machine deterministically. Transitions are reported to an optional
``observer(name, old, new, reason)`` AFTER the lock is released: observers
feed the flight recorder and the metrics and never run under the breaker
lock (``serving/locks.py``'s ``breaker.lock``: no store I/O, no sleeps, no
device syncs while it is held).
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from collections import deque
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class StoreUnavailableError(RuntimeError):
    """Fail-fast refusal: the store's circuit breaker is open, so the
    operation was not attempted at all (no disk syscalls were made).
    Deliberately NOT an ``OSError``: the retry layer retries OSErrors,
    and retrying a refusal would reintroduce the very backoff storm the
    breaker exists to prevent. Callers map it to their degradation
    policy — prefix lookups to a miss, session saves to a DIRTY pin,
    session-carrying admissions to a retriable shed."""

    def __init__(self, store: str, detail: str = ""):
        self.store = store
        msg = f"store '{store}' unavailable (circuit breaker open)"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class CircuitBreaker:
    """Windowed failure-rate / consecutive-failure circuit breaker.

    - ``window``/``min_samples``/``failure_rate``: open when at least
      ``min_samples`` of the last ``window`` completed operations are
      recorded and the failing fraction reaches ``failure_rate``.
    - ``consecutive_failures``: open immediately on this many failures
      in a row (the fast path for a hard outage).
    - ``backoff``/``max_backoff``/``jitter``: open-state dwell before the
      half-open probe; doubles per consecutive failed probe, jitter only
      ever stretches (tests can lower-bound the dwell exactly, like
      retry.py's delays).
    - ``clock``: injectable monotonic clock.
    - ``observer``: ``(name, old_state, new_state, reason)`` called
      outside the lock on every transition.
    """

    def __init__(
        self,
        name: str,
        *,
        window: int = 16,
        min_samples: int = 8,
        failure_rate: float = 0.5,
        consecutive_failures: int = 3,
        backoff: float = 0.5,
        max_backoff: float = 30.0,
        jitter: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
        observer: Optional[Callable[[str, str, str, str], None]] = None,
    ):
        assert window >= 1 and min_samples >= 1, (window, min_samples)
        assert consecutive_failures >= 1, consecutive_failures
        self.name = name
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.failure_rate = float(failure_rate)
        self.consecutive_failures = int(consecutive_failures)
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self._clock = clock
        self._observer = observer
        # deterministic jitter per breaker name, like retry.py's
        # describe-seeded rng: a given breaker backs off identically
        # run to run
        self._rng = random.Random(zlib.crc32(name.encode()))
        self._lock = threading.Lock()
        self._state = CLOSED
        self._results: deque = deque(maxlen=self.window)  # True = success
        self._consec = 0
        self._trips = 0  # consecutive open episodes (backoff exponent)
        self._probe_at = 0.0
        self._opened_at = 0.0
        self._open_count = 0  # lifetime trips, for telemetry
        self._last_reason = ""

    # -- state ----------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def is_open(self) -> bool:
        """True while gated operations are refused OR probing — i.e. the
        store is not known-good. Use :meth:`blocked` for the per-syscall
        fast check."""
        with self._lock:
            return self._state != CLOSED

    def blocked(self) -> bool:
        """O(1) host check: would a gated operation be refused right now?
        Pure read — never consumes the half-open probe slot, so raw-I/O
        helpers can call it per syscall while an admitted probe operation
        is in flight."""
        with self._lock:
            if self._state != OPEN:
                return False
            return self._clock() < self._probe_at

    def allow(self) -> bool:
        """Operation-level gate. Closed: always True. Open: False until
        the jittered backoff expires, then transitions to half-open and
        admits exactly ONE probe (concurrent callers get False until the
        probe reports). Half-open: False (a probe is in flight)."""
        notify = None
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and self._clock() >= self._probe_at:
                notify = (self._state, HALF_OPEN, "probe")
                self._state = HALF_OPEN
                ok = True
            else:
                ok = False
        if notify is not None:
            self._notify(*notify)
        return ok

    # -- samples --------------------------------------------------------------

    def record_success(self) -> None:
        notify = None
        with self._lock:
            if self._state == HALF_OPEN:
                notify = (self._state, CLOSED, "probe succeeded")
                self._close_locked()
            elif self._state == CLOSED:
                self._results.append(True)
                self._consec = 0
            # OPEN: a straggler operation that started before the trip;
            # the half-open probe is the only sanctioned evidence of
            # recovery, so this is recorded nowhere.
        if notify is not None:
            self._notify(*notify)

    def record_failure(self, reason: str = "") -> None:
        notify = None
        with self._lock:
            if self._state == HALF_OPEN:
                self._trips += 1
                notify = (self._state, OPEN,
                          reason or "probe failed")
                self._open_locked(reason or "probe failed")
            elif self._state == CLOSED:
                self._results.append(False)
                self._consec += 1
                failures = sum(1 for r in self._results if not r)
                rate_trip = (
                    len(self._results) >= self.min_samples
                    and failures / len(self._results) >= self.failure_rate
                )
                if self._consec >= self.consecutive_failures or rate_trip:
                    self._trips = 1
                    why = reason or (
                        f"{self._consec} consecutive failures"
                        if self._consec >= self.consecutive_failures
                        else f"{failures}/{len(self._results)} recent "
                             "operations failed"
                    )
                    notify = (self._state, OPEN, why)
                    self._open_locked(why)
            # OPEN: already refusing; nothing new to learn.
        if notify is not None:
            self._notify(*notify)

    # -- internals (call with the lock held) ----------------------------------

    def _open_locked(self, reason: str) -> None:
        self._state = OPEN
        self._opened_at = self._clock()
        self._open_count += 1
        self._last_reason = reason
        dwell = min(self.max_backoff,
                    self.backoff * (2 ** max(self._trips - 1, 0)))
        dwell *= 1.0 + self.jitter * self._rng.random()
        self._probe_at = self._opened_at + dwell

    def _close_locked(self) -> None:
        self._state = CLOSED
        self._results.clear()
        self._consec = 0
        self._trips = 0
        self._last_reason = ""

    def _notify(self, old: str, new: str, reason: str) -> None:
        if self._observer is not None:
            try:
                self._observer(self.name, old, new, reason)
            except Exception:
                pass  # telemetry must never mask the store's own fate

    # -- telemetry ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Host-only state for the Server's snapshot (its failure-domain
        section)."""
        with self._lock:
            now = self._clock()
            return {
                "name": self.name,
                "state": self._state,
                "consecutive_failures": self._consec,
                "window_failures": sum(
                    1 for r in self._results if not r),
                "window_samples": len(self._results),
                "trips": self._open_count,
                "probe_in_secs": (
                    max(self._probe_at - now, 0.0)
                    if self._state == OPEN else 0.0
                ),
                "open_secs": (
                    now - self._opened_at
                    if self._state != CLOSED else 0.0
                ),
                "reason": self._last_reason,
            }


__all__ = ["CircuitBreaker", "StoreUnavailableError",
           "CLOSED", "OPEN", "HALF_OPEN"]
