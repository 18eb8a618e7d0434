"""Preemption-safe shutdown: SIGTERM/SIGINT -> graceful stop request. The
port's copy of ``orion_tpu/resilience/preempt.py``, whole (it imports no jax).

A preemption is a SIGTERM plus a grace window; dying mid-step loses up
to ``ckpt_every`` steps and can tear a checkpoint write. The guard converts
the first signal into a flag the trainer polls at step boundaries — the
only place the TrainState is consistent — where it force-saves an emergency
checkpoint and exits resumable. A second signal means the operator (or the
scheduler's KILL escalation path) insists: the original disposition is
restored and the signal re-delivered, so ctrl-C ctrl-C still kills.

``grace`` is the budget (seconds, from signal receipt) for finishing the
in-flight step plus the emergency save; :meth:`remaining_grace` lets the
caller skip optional work (eval, retention GC) when the clock is short.
Signal handlers only install from the main thread — elsewhere (library use
inside a server worker) the guard degrades to the :meth:`request_stop`
programmatic path with a warning rather than failing.
"""

from __future__ import annotations

import os
import signal
import threading
import time
import warnings
from typing import Callable, Dict, Optional, Tuple


class PreemptionGuard:
    def __init__(
        self,
        grace: float = 10.0,
        signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
        clock: Callable[[], float] = time.monotonic,
        on_stop: Optional[Callable[[int], None]] = None,
    ):
        self.grace = float(grace)
        self._signals = signals
        self._clock = clock
        # telemetry tap: called once with the signal number when the
        # graceful-stop request is recorded. It runs from the signal
        # handler context, so it must only touch memory (append to a
        # flight ring) — no I/O, no locks (signal-unsafe-handler rule;
        # the flight recorder's deque append qualifies).
        self._on_stop = on_stop
        self._orig: Dict[int, object] = {}
        self._requested_at: Optional[float] = None
        self._signum: Optional[int] = None

    # -- context manager -----------------------------------------------------

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            warnings.warn(
                "PreemptionGuard: not the main thread, signal handlers not "
                "installed — only request_stop() will trigger graceful stop",
                stacklevel=2,
            )
            return self
        for s in self._signals:
            self._orig[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        self._restore()

    def _restore(self) -> None:
        for s, h in self._orig.items():
            signal.signal(s, h)
        self._orig = {}

    # -- signal path ---------------------------------------------------------

    def _handle(self, signum, frame) -> None:
        if self._requested_at is not None:
            # second signal: stop being graceful — restore the original
            # disposition and re-deliver so the default/outer behavior
            # (KeyboardInterrupt, process death) happens immediately
            self._restore()
            signal.raise_signal(signum)
            return
        self._requested_at = self._clock()
        self._signum = signum
        if self._on_stop is not None:
            try:
                self._on_stop(signum)
            except Exception:
                pass  # telemetry must never break the stop request
        # os.write, not sys.stderr.write: the handler runs between two
        # arbitrary bytecodes, and buffered io locks internally — if the
        # interrupted code holds that lock (a log line mid-flush), a
        # buffered write here deadlocks at exactly the moment preemption
        # handling must not. The raw fd-2 syscall is async-signal-safe.
        # (analysis rule: signal-unsafe-handler)
        os.write(2, (
            f"[preempt] caught signal {signum}: requesting graceful stop at "
            f"the next step boundary (grace {self.grace:.0f}s; signal again "
            "to kill)\n"
        ).encode())

    def request_stop(self, signum: int = signal.SIGTERM) -> None:
        """Programmatic stop request (tests, non-main-thread embedders)."""
        if self._requested_at is None:
            self._requested_at = self._clock()
            self._signum = signum
            if self._on_stop is not None:
                try:
                    self._on_stop(signum)
                except Exception:
                    pass

    # -- trainer-facing API --------------------------------------------------

    @property
    def should_stop(self) -> bool:
        return self._requested_at is not None

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def remaining_grace(self) -> float:
        if self._requested_at is None:
            return self.grace
        return max(0.0, self.grace - (self._clock() - self._requested_at))


__all__ = ["PreemptionGuard"]
