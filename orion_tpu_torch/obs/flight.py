"""Flight recorder: a bounded ring of recent structured events (ladder
rungs, for a start) that a post-mortem reads in order. The port's copy of
``orion_tpu/obs/flight.py``, trimmed to what ``serving.DecodeSession``
uses: :class:`FlightRecorder` with ``record`` / ``events`` / ``clear``, the
process-default recorder and :func:`record`.

Host-only: every recorded field is a host value, and recording never reads
the card. Left out (ROADMAP.md A9, the host subsystems): dumps to a run
directory, the signal-safe append, the fault-delivery subscription
(``attach_inject``) and ``configure``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional


class FlightRecorder:
    def __init__(self, capacity: int = 2048, clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self.capacity = capacity
        self.dropped = 0  # events that scrolled off: the ring is a suffix

    def record(self, kind: str, **fields) -> None:
        """Append one event; ``fields`` are plain host values."""
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append((self._clock(), kind, fields or None))

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            rows = list(self._ring)
        out = []
        for t, k, fields in rows:
            if kind is None or k == kind:
                out.append({"t": t, "kind": k, **(fields or {})})
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0


_default = FlightRecorder()


def recorder() -> FlightRecorder:
    """The process-default recorder (the solo session feeds it)."""
    return _default


def record(kind: str, **fields) -> None:
    """Record into the default recorder."""
    _default.record(kind, **fields)


__all__ = ["FlightRecorder", "recorder", "record"]
