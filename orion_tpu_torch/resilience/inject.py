"""Deterministic fault injection at named hook points: the port's copy of
``orion_tpu/resilience/inject.py``, trimmed to the sites the port fires.

Production code carries permanent, near-zero-cost hooks -- ``fire(site,
step=...)`` -- that are inert until a test arms a :class:`FaultPlan` with
the :func:`inject` context manager. Faults are addressed by ``(site, step,
occurrence count)``, so a test can say "poison the decode state after chunk
2's attempt twice, then stop" and get exactly that.

Sites wired in the port:

========================  ====================================================
``"serve.chunk"``         ``serving/session.py`` DecodeSession, at each decode
                          chunk boundary (step = the request's chunk index);
                          ``serving/batching.py`` SlotEngine, at each boundary
                          (step = the engine's boundary index) -- where
                          :meth:`FaultPlan.preempt_at_chunk` delivers a real
                          SIGTERM, which the Server's PreemptionGuard turns
                          into a drain
``"serve.chunk_delay"``   ``serving/server.py`` ``Server._step_chunk``, inside
                          the timed chunk boundary (step = the server's
                          lifetime chunk ordinal): :meth:`FaultPlan.delay_chunk`
                          adds host latency that ``chunk_ms`` sees
``"serve.ckpt_load"``     ``training/checkpoint.py`` ``load_params``, inside the
                          retry region (step = the checkpoint step)
``"serve.tokenizer_io"``  ``serving/server.py`` ``load_tokenizer``, inside the
                          retry region
``"decode.state_nan"``    consumed through :func:`decode_nan_armed` by
                          DecodeSession to poison one chunk attempt's decode
                          state to NaN: 1, 2 or unlimited deliveries at a chunk
                          reach the rewind, the re-prefill and the failed rung;
                          SlotEngine consumes it too, for every resident slot
``"decode.slot_nan.K"``   consumed through :func:`decode_slot_nan_armed` by
                          SlotEngine to poison only slot K's rows of the
                          batched decode state at that request's chunk index:
                          the per-slot ladder's address
========================  ====================================================

Every delivered fault, marker or action, is reported to the delivery
observers (:func:`add_observer`) after the plan's lock is released: the
flight recorder subscribes (``FlightRecorder.attach_inject``), so no
injected fault leaves the black box without a trace.

Left out, with the ROADMAP.md item that brings each: the training,
checkpoint-save, data and store sites, the sustained fault regimes
(``degrade_site``) and the on-disk corruption helpers (A9, the host
subsystems; the stores' sites with A8 step 3).
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import threading
import time
from typing import Callable, List, Optional

_DECODE_NAN_SITE = "decode.state_nan"
_CHUNK_SITE = "serve.chunk"

# every wired hook site (site -> where it fires); FaultPlan.add rejects any
# other name, so a typo'd site cannot be armed and never deliver
SITES = {
    "serve.chunk": "serving decode loops, each chunk boundary",
    "serve.chunk_delay": "serving/server.py _step_chunk, inside the timed chunk boundary "
                         "(step = server-lifetime chunk ordinal)",
    "serve.ckpt_load": "training/checkpoint.py load_params, inside retry",
    "serve.tokenizer_io": "serving/server.py tokenizer load, inside retry",
    "decode.state_nan": "DecodeSession decode-state poisoning marker",
}


# site families addressed by a suffix (matched by prefix)
SITE_PREFIXES = ("decode.slot_nan.",)


def known_site(site: str) -> bool:
    return site in SITES or site.startswith(SITE_PREFIXES)


def _decode_slot_site(slot: int) -> str:
    """Slot-addressed decode-state poisoning site (the batched engine's
    per-slot counterpart of ``decode.state_nan``)."""
    return f"decode.slot_nan.{slot}"


# delivery observers: every DELIVERED fault is reported to each subscribed
# callback as (site, step) after the plan lock is released (an observer
# that records, dumps or logs must never run under the delivery lock)
_observers: List[Callable[[str, Optional[int]], None]] = []


def add_observer(fn: Callable[[str, Optional[int]], None]) -> None:
    if fn not in _observers:
        _observers.append(fn)


def remove_observer(fn: Callable[[str, Optional[int]], None]) -> None:
    try:
        _observers.remove(fn)
    except ValueError:
        pass


def _notify_delivery(site: str, step: Optional[int]) -> None:
    for fn in list(_observers):
        try:
            fn(site, step)
        except Exception:
            pass  # a broken observer must never mask the fault itself


@dataclasses.dataclass
class _Fault:
    site: str
    step: Optional[int]  # None = any step
    times: int  # remaining deliveries; <0 = unlimited
    action: Optional[Callable[[], None]]  # None = marker (consumed via query)


class FaultPlan:
    """An ordered set of faults to deliver. Thread-safe."""

    def __init__(self):
        self._faults: List[_Fault] = []
        self._lock = threading.Lock()
        self.delivered: List[str] = []  # "site@step" log for assertions

    def add(self, site: str, step: Optional[int] = None, times: int = 1,
            action: Optional[Callable[[], None]] = None) -> "FaultPlan":
        if not known_site(site):
            raise ValueError(
                f"unknown fault-injection site {site!r}: a fault armed at a "
                "site no hook fires never delivers -- register it in "
                "inject.SITES first"
            )
        self._faults.append(_Fault(site, step, times, action))
        return self

    def fail_io(self, site: str, step: Optional[int] = None, times: int = 1,
                exc: type = OSError, msg: str = "injected I/O fault") -> "FaultPlan":
        """Raise ``exc`` from the hook: the retry layer sees a transient
        storage error exactly where a real one would surface."""

        def raise_():
            raise exc(f"{msg} [site={site}]")

        return self.add(site, step, times, raise_)

    def preempt_at_chunk(self, chunk: int, sig: int = signal.SIGTERM) -> "FaultPlan":
        """Deliver a real OS signal at a serving chunk boundary (SlotEngine:
        the engine's boundary index). With the Server's PreemptionGuard
        installed this drives the DRAINING path end to end: the in-flight
        requests complete, new ones are rejected, the loop exits 0."""
        return self.add(_CHUNK_SITE, chunk, 1, lambda: signal.raise_signal(sig))

    def delay_chunk(self, seconds: float, chunk: Optional[int] = None,
                    times: int = 1) -> "FaultPlan":
        """Add ``seconds`` of host latency at a serving chunk boundary (site
        ``serve.chunk_delay``; step = the server-lifetime chunk ordinal,
        ``None`` = every boundary; ``times < 0`` = unlimited), inside the
        window ``chunk_ms`` measures."""
        return self.add("serve.chunk_delay", chunk, times, lambda: time.sleep(seconds))

    def poison_decode_state_at(self, chunk: int, times: int = 1) -> "FaultPlan":
        """Arm NaN-poisoning of the decode state after each attempt at a
        chunk (consumed by DecodeSession through :func:`decode_nan_armed`).
        ``times=1`` exercises the rewind rung, ``times=2`` the re-prefill
        rung, ``times<0`` (unlimited) exhausts the ladder and fails the
        request."""
        return self.add(_DECODE_NAN_SITE, chunk, times, None)

    def poison_decode_slot_at(self, slot: int, chunk: int, times: int = 1) -> "FaultPlan":
        """Arm NaN-poisoning of one slot's rows of SlotEngine's batched
        decode state, at that slot's request-local chunk index; the rungs as
        :meth:`poison_decode_state_at`, walked by that request alone while
        the slots beside it stream on."""
        return self.add(_decode_slot_site(slot), chunk, times, None)

    def _take(self, site: str, step: Optional[int]) -> Optional[_Fault]:
        taken = None
        with self._lock:
            for f in self._faults:
                if f.site != site or f.times == 0:
                    continue
                if f.step is not None and f.step != step:
                    continue
                if f.times > 0:
                    f.times -= 1
                self.delivered.append(f"{site}@{step}")
                taken = f
                break
        if taken is not None:
            _notify_delivery(site, step)
        return taken

    def fire(self, site: str, step: Optional[int] = None) -> None:
        f = self._take(site, step)
        if f is not None and f.action is not None:
            f.action()

    def consume_marker(self, site: str, step: Optional[int] = None) -> bool:
        return self._take(site, step) is not None


_active: Optional[FaultPlan] = None


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Arm ``plan`` for the duration of the block."""
    global _active
    prev = _active
    _active = plan
    try:
        yield plan
    finally:
        _active = prev


def active() -> bool:
    """Is any fault plan armed? Hot-path callers ask this before they
    compute a hook's arguments."""
    return _active is not None


def fire(site: str, step: Optional[int] = None) -> None:
    """Production hook: no-op (one global read) unless a plan is armed."""
    plan = _active
    if plan is not None:
        plan.fire(site, step)


def decode_nan_armed(chunk: int) -> bool:
    """Is a decode-state NaN-poisoning armed for this chunk? Consumes one
    delivery: DecodeSession asks again after every attempt at the chunk, so
    a multi-delivery plan poisons each attempt in turn."""
    plan = _active
    return plan is not None and plan.consume_marker(_DECODE_NAN_SITE, chunk)


def decode_slot_nan_armed(slot: int, chunk: int) -> bool:
    """Is a slot-addressed decode-state poisoning armed for (slot, that
    request's chunk index)? Consumed per attempt, as
    :func:`decode_nan_armed`."""
    plan = _active
    return plan is not None and plan.consume_marker(_decode_slot_site(slot), chunk)


__all__ = ["SITES", "SITE_PREFIXES", "FaultPlan", "inject", "active", "fire",
           "decode_nan_armed", "decode_slot_nan_armed", "known_site", "add_observer",
           "remove_observer"]
