"""Hang detection: heartbeat watchdog + :class:`StallError`. The port's copy
of ``orion_tpu/resilience/watchdog.py``, whole (it imports no jax).

A hung device step (deadlocked collective, wedged DMA) or a stalled data
loader (dead NFS mount) otherwise blocks the trainer forever with zero
diagnostics. The watchdog turns "hangs forever" into "raises a diagnosable
:class:`StallError` (or invokes ``on_stall``) after ``timeout`` seconds of
heartbeat silence".

Two modes share one class:

- **manual** (``monitor=False``): the owner calls :meth:`check` at its own
  cadence; with an injectable ``clock`` this is exactly unit-testable.
- **threaded** (``monitor=True``): a daemon thread polls wall time and
  invokes ``on_stall(diagnosis)`` once per stall, then again after each
  further ``timeout`` of continued silence (escalation). The built-in
  handler (``on_stall=None``) dumps every thread's stack to stderr (the
  diagnosable part) and then escalates: attempt 1 interrupts the main
  thread — with a PreemptionGuard installed that is absorbed as a graceful
  stop request, so a stalled run downgrades to a preemption, emergency
  checkpoint included (an owner that saves across that stop disarms the
  watchdog so escalation can't kill it); attempt 2 interrupts again, driving the
  guard's second-signal die-now path; if the stall persists to attempt 3
  (a wedged C call never returns to the interpreter, so no interrupt can
  land), it aborts the process with exit code 86 so the scheduler restarts
  it — resumable from the last checkpoint, instead of an opaque
  forever-hang.

The serving loop (``serving/server.py``) beats once per chunk boundary and
once per admission; the first interval therefore includes the kernels'
build on the card, so ``timeout`` (the ``--stall-timeout`` knob) must
comfortably exceed the build + one chunk, not just one chunk.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional


class StallError(RuntimeError):
    """A monitored operation exceeded its deadline; the message carries the
    diagnosis (what was armed, how long it was silent, peer liveness)."""


STALL_ABORT_EXIT_CODE = 86  # documented: "watchdog abort, resume me"


class Watchdog:
    def __init__(
        self,
        timeout: float,
        clock: Callable[[], float] = time.monotonic,
        on_stall: Optional[Callable[[str], None]] = None,
        monitor: bool = True,
        poll_interval: Optional[float] = None,
        label: str = "train step",
        observer: Optional[Callable[[str, str], None]] = None,
    ):
        assert timeout > 0, timeout
        self.timeout = float(timeout)
        self._clock = clock
        self._on_stall = on_stall  # None = built-in escalating handler
        # telemetry tap (the flight recorder): called as ("beat", label)
        # on every heartbeat and ("stall", diagnosis) on every trip —
        # must be host-only and cheap (it never reads the card)
        self._observer = observer
        self._label = label
        self._lock = threading.Lock()
        self._last = self._clock()
        self._beats = 0
        self._armed = True
        self._tripped = False
        self._trip_at = 0.0
        self.trip_attempt = 0  # per-stall escalation counter
        self.last_stall: Optional[str] = None
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if monitor:
            # real-time poll cadence regardless of the (possibly fake) clock;
            # short enough that a stall is caught within ~timeout * 1.25
            self._poll = (
                poll_interval
                if poll_interval is not None
                else max(0.05, min(self.timeout / 4.0, 1.0))
            )
            self._thread = threading.Thread(
                target=self._run, name="orion-watchdog", daemon=True
            )
            self._thread.start()

    # -- owner API -----------------------------------------------------------

    def beat(self, label: Optional[str] = None) -> None:
        """Record liveness; resets the stall window (and re-arms after a
        trip, so a recovered stall can be caught again)."""
        with self._lock:
            self._last = self._clock()
            self._beats += 1
            self._tripped = False
            self.trip_attempt = 0
            if label is not None:
                self._label = label
        if self._observer is not None:
            try:
                self._observer("beat", self._label)
            except Exception:
                pass  # telemetry must never fail a heartbeat

    def disarm(self) -> None:
        """Pause detection (e.g. across a legitimately unbounded phase)."""
        with self._lock:
            self._armed = False

    def arm(self, label: Optional[str] = None) -> None:
        with self._lock:
            self._armed = True
        self.beat(label)

    def _stalled(self) -> Optional[str]:
        """One diagnosis per trip; a persisting stall re-trips (escalates)
        after each further full ``timeout`` of silence."""
        with self._lock:
            if not self._armed:
                return None
            now = self._clock()
            elapsed = now - self._last
            if elapsed <= self.timeout:
                return None
            if self._tripped and now - self._trip_at <= self.timeout:
                return None
            self._tripped = True
            self._trip_at = now
            self.trip_attempt += 1
            return (
                f"stall detected (attempt {self.trip_attempt}): no "
                f"heartbeat from '{self._label}' for {elapsed:.1f}s "
                f"(timeout {self.timeout:.1f}s, {self._beats} beat(s) seen)"
            )

    def check(self) -> None:
        """Manual-mode probe: raise :class:`StallError` if the heartbeat is
        stale. Also usable alongside the monitor thread for a synchronous
        raise point."""
        diag = self._stalled()
        if diag is not None:
            self.last_stall = diag
            if self._observer is not None:
                try:
                    self._observer("stall", diag)
                except Exception:
                    pass  # telemetry must never mask the StallError
            raise StallError(diag)

    def close(self) -> None:
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- monitor thread ------------------------------------------------------

    def _run(self) -> None:
        while not self._closed.wait(self._poll):
            diag = self._stalled()
            if diag is not None:
                self.last_stall = diag
                if self._observer is not None:
                    try:
                        self._observer("stall", diag)
                    except Exception:
                        pass  # telemetry must never mask the stall
                try:
                    if self._on_stall is not None:
                        self._on_stall(diag)
                    else:
                        self._builtin_on_stall(diag)
                except Exception as e:  # a raising callback must not kill
                    sys.stderr.write(  # the monitor (it re-arms on beat)
                        f"[watchdog] on_stall callback raised: {e!r}\n"
                    )

    def _builtin_on_stall(self, diag: str) -> None:
        sys.stderr.write(f"[watchdog] {diag}\n")
        try:
            faulthandler.dump_traceback(file=sys.stderr)
        except Exception as e:  # diagnostics must never mask the stall
            sys.stderr.write(f"[watchdog] stack dump failed: {e!r}\n")
        if self.trip_attempt < 3:
            # graceful: lands as SIGINT in the main thread — an installed
            # PreemptionGuard absorbs it as a stop request (emergency
            # checkpoint at the step boundary); a second attempt drives the
            # guard's insist path
            import _thread

            _thread.interrupt_main()
        else:
            # a wedged C call never returns to the interpreter, so no
            # interrupt can land — abort with the documented code so the
            # scheduler restarts us, resumable from the last checkpoint
            sys.stderr.write(
                "[watchdog] graceful stop did not land after "
                f"{self.trip_attempt - 1} attempt(s); aborting process "
                f"(exit {STALL_ABORT_EXIT_CODE})\n"
            )
            sys.stderr.flush()
            os._exit(STALL_ABORT_EXIT_CODE)


__all__ = ["StallError", "Watchdog", "STALL_ABORT_EXIT_CODE"]
