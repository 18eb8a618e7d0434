"""Deterministic fault injection at named hook points: the port's copy of
``orion_tpu/resilience/inject.py``, with the sites the port fires.

Production code carries permanent, near-zero-cost hooks -- ``fire(site,
step=...)`` -- that are inert until a test arms a :class:`FaultPlan` with
the :func:`inject` context manager. Faults are addressed by ``(site, step,
occurrence count)``, so a test can say "poison the decode state after chunk
2's attempt twice, then stop" and get exactly that.

Sites wired in the port:

========================  ====================================================
``"ckpt.save"``           ``training/checkpoint.py`` ``Checkpointer.maybe_save``,
                          inside the retried write (step = the checkpoint
                          step)
``"ckpt.restore"``        ``training/checkpoint.py`` ``Checkpointer.restore``,
                          inside the retried read (step = the checkpoint step)
``"data.batch"``          ``training/data.py`` prefetch worker, inside the
                          retried fetch (step = the batch's step)
``"train.step_boundary"`` ``Trainer.train``, after each step's bookkeeping --
                          where :meth:`FaultPlan.preempt_at` delivers a real
                          SIGTERM, which the installed PreemptionGuard turns
                          into an emergency checkpoint and a resumable exit
``"train.nan"``           consumed through :func:`nan_armed` by ``Trainer.step``
                          to poison one step's params, and so its loss and
                          gradients, to NaN
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
``"serve.session_save"``  ``serving/session_store.py`` ``SessionStore.save``,
                          inside the retried write of one session generation
                          (step = the generation number)
``"serve.session_load"``  ``serving/session_store.py`` ``SessionStore.load``,
                          inside the retried read of one session generation
                          (step = the generation number)
``"serve.session_scan"``  ``serving/session_store.py``, before each directory
                          listing: the staleness probe a session lookup pays
``"serve.prefix_scan"``   ``serving/prefix_store.py``, before each directory
                          listing: the existence probe of a prefix candidate
``"serve.prefix_save"``   ``serving/prefix_store.py`` ``PrefixStore.publish``,
                          inside the retried write of one prefix generation
                          (step = the generation number): a kill here leaves
                          the previous generation the newest committed
``"serve.prefix_load"``   ``serving/prefix_store.py`` lookup, inside the
                          retried read of one candidate generation (step = the
                          generation number): a fault here falls back to a
                          cold prefill, never fails the request
``"fleet.dispatch"``      ``fleet/router.py`` ``Router.submit``, before each
                          replica-placement attempt (step = the fleet-wide
                          dispatch ordinal): a fault here fails over to the
                          next candidate replica
``"fleet.replica_spawn"`` ``fleet/supervisor.py`` replica spawn, inside the
                          retry region (step = the spawn ordinal)
``"fleet.control_io"``    ``fleet/replica.py`` ``ProcessReplica``'s control
                          channel writes (parent side): an injected OSError
                          models a broken pipe to a dead child
========================  ====================================================

Besides one-shot faults, :meth:`FaultPlan.degrade_site` arms a SUSTAINED
regime (:data:`REGIME_KINDS`: ``eio``, ``enospc``, ``partition`` raise the
matching OSError, ``latency`` sleeps and succeeds) on every site under a
prefix while a regime clock (by default the Server's ``serve.chunk_delay``
ordinal) sits inside a window: the store outages the circuit breakers
(``resilience/breaker.py``) are held against. :func:`corrupt_step` and
:func:`truncate_step` damage a written checkpoint step on disk the way flaky
storage does (the verified restore of ``training/checkpoint.py`` falls back
past it), :func:`corrupt_session` and :func:`truncate_session` a written
session (or prefix) generation.

Every delivered fault, marker or action, is reported to the delivery
observers (:func:`add_observer`) after the plan's lock is released: the
flight recorder subscribes (``FlightRecorder.attach_inject``), so no
injected fault leaves the black box without a trace.

Left out, with the ROADMAP.md item that brings them: the executable store's
sites (``serve.exec_*``: A13).
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

_NAN_SITE = "train.nan"
_DECODE_NAN_SITE = "decode.state_nan"
_CHUNK_SITE = "serve.chunk"

# every wired hook site (site -> where it fires); FaultPlan.add rejects any
# other name, so a typo'd site cannot be armed and never deliver
SITES = {
    "ckpt.save": "training/checkpoint.py maybe_save, inside retry",
    "ckpt.restore": "training/checkpoint.py restore, inside retry",
    "data.batch": "training/data.py prefetch worker, inside retry",
    "train.step_boundary": "trainer loop, each step boundary",
    "train.nan": "Trainer.step NaN poisoning marker",
    "serve.chunk": "serving decode loops, each chunk boundary",
    "serve.chunk_delay": "serving/server.py _step_chunk, inside the timed chunk boundary "
                         "(step = server-lifetime chunk ordinal)",
    "serve.ckpt_load": "training/checkpoint.py load_params, inside retry",
    "serve.tokenizer_io": "serving/server.py tokenizer load, inside retry",
    "decode.state_nan": "DecodeSession decode-state poisoning marker",
    "serve.session_save": "serving/session_store.py save, inside retry",
    "serve.session_load": "serving/session_store.py load, inside retry",
    "serve.session_scan": "serving/session_store.py generations(), before the directory "
                          "listing -- the staleness probe a session lookup pays",
    "serve.prefix_scan": "serving/prefix_store.py generations(), before the directory "
                         "listing -- the per-candidate existence probe of a prefix lookup",
    "serve.prefix_save": "serving/prefix_store.py publish, inside the retried write of one "
                         "prefix generation",
    "serve.prefix_load": "serving/prefix_store.py lookup, inside the retried read of one "
                         "candidate generation",
    "fleet.dispatch": "fleet/router.py submit, before each placement attempt (step = fleet-wide "
                      "dispatch ordinal)",
    "fleet.replica_spawn": "fleet/supervisor.py _spawn, inside the spawn retry region (step = "
                           "spawn ordinal)",
    "fleet.control_io": "fleet/replica.py control-channel write (parent side), before the pipe "
                        "I/O",
}


# site families addressed by a suffix (matched by prefix)
SITE_PREFIXES = ("decode.slot_nan.",)


# sustained-regime fault kinds (FaultPlan.degrade_site): how a degraded site
# fails for the whole regime window. ``eio`` / ``enospc`` raise the matching
# OSError (media failure / full disk), ``partition`` raises ETIMEDOUT (a
# network-attached store whose network is gone), ``latency`` adds host delay
# and succeeds: the brownout a breaker must catch with no error surfacing
REGIME_KINDS = ("eio", "enospc", "latency", "partition")

_REGIME_ERRNO = {
    "eio": errno.EIO,
    "enospc": errno.ENOSPC,
    "partition": errno.ETIMEDOUT,
}


def known_site(site: str) -> bool:
    return site in SITES or site.startswith(SITE_PREFIXES)


def known_regime_prefix(prefix: str) -> bool:
    """A regime prefix must cover at least one registered site (or site
    family): a regime that can never fire is a typo, the contract of
    :meth:`FaultPlan.add`."""
    return (any(s == prefix or s.startswith(prefix) for s in SITES)
            or any(p == prefix or p.startswith(prefix) for p in SITE_PREFIXES)
            or prefix.startswith(SITE_PREFIXES))


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


@dataclasses.dataclass
class _Regime:
    """A sustained outage: every fire() on a site matching ``prefix`` fails
    (or stalls) while the regime clock is inside ``[from_step, until_step)``.
    The clock is the last step observed at ``clock_site`` (by default
    ``serve.chunk_delay``, the Server's lifetime chunk ordinal), so "the
    store is down for chunks 10..30" is one sentence however each store
    site numbers its own steps (generation numbers, ...)."""

    prefix: str
    kind: str  # one of REGIME_KINDS
    from_step: int
    until_step: Optional[int]  # exclusive; None = never ends
    latency: float
    clock_site: str


class FaultPlan:
    """An ordered set of faults to deliver. Thread-safe: the data loader's
    worker and the main thread both fire hooks."""

    def __init__(self):
        self._faults: List[_Fault] = []
        self._regimes: List[_Regime] = []
        self._regime_clock: Dict[str, int] = {}  # clock_site -> last step
        self._lock = threading.Lock()
        self.delivered: List[str] = []  # "site@step" log for assertions
        self.sleep: Callable[[float], None] = time.sleep  # latency regimes

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

    def degrade_site(self, prefix: str, kind: str = "eio", from_step: int = 0,
                     until_step: Optional[int] = None, latency: float = 0.05,
                     clock_site: str = "serve.chunk_delay") -> "FaultPlan":
        """Arm a SUSTAINED fault regime: every hook whose site starts with
        ``prefix`` fails (``kind`` in :data:`REGIME_KINDS`) while the regime
        clock -- the last step fired at ``clock_site`` (default
        ``serve.chunk_delay``, the Server's lifetime chunk ordinal) -- sits
        in ``[from_step, until_step)``. ``until_step=None`` never recovers.
        ``latency`` is the added host delay per operation for
        ``kind="latency"`` (the operation then SUCCEEDS). Regimes layer
        under one-shot faults: an armed one-shot at the same (site, step)
        takes precedence."""
        if kind not in REGIME_KINDS:
            raise ValueError(f"unknown regime kind {kind!r}; expected one of {REGIME_KINDS}")
        if not known_regime_prefix(prefix):
            raise ValueError(
                f"regime prefix {prefix!r} covers no registered fault-injection site: a regime "
                "no hook can enter never delivers -- register the site(s) in inject.SITES first")
        if not known_site(clock_site):
            raise ValueError(f"unknown regime clock site {clock_site!r}")
        if until_step is not None and until_step <= from_step:
            raise ValueError(f"empty regime window [{from_step}, {until_step})")
        self._regimes.append(_Regime(prefix, kind, int(from_step),
                                     None if until_step is None else int(until_step),
                                     float(latency), clock_site))
        return self

    def preempt_at(self, step: int, sig: int = signal.SIGTERM) -> "FaultPlan":
        """Deliver a real OS signal at a training step's boundary. With a
        PreemptionGuard installed this drives the whole graceful stop:
        handler -> stop request -> emergency checkpoint -> resumable exit."""
        return self.add("train.step_boundary", step, 1, lambda: signal.raise_signal(sig))

    def poison_nan_at(self, step: int) -> "FaultPlan":
        """Arm NaN poisoning for one training step (consumed by
        ``Trainer.step`` through :func:`nan_armed`)."""
        return self.add(_NAN_SITE, step, 1, None)

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
        if self._regimes:
            self._advance_regime_clock(site, step)
        f = self._take(site, step)
        if f is not None:
            if f.action is not None:
                f.action()
            return
        if self._regimes:
            self._fire_regime(site, step)

    def _advance_regime_clock(self, site: str, step: Optional[int]) -> None:
        if step is None:
            return
        with self._lock:
            for r in self._regimes:
                if r.clock_site == site:
                    self._regime_clock[site] = max(self._regime_clock.get(site, -1), int(step))

    def _fire_regime(self, site: str, step: Optional[int]) -> None:
        """Deliver the first matching live regime (logged in ``delivered``
        and reported to the observers as a one-shot fault is). ``eio`` /
        ``enospc`` / ``partition`` raise; ``latency`` sleeps outside the
        lock, then succeeds."""
        match = None
        with self._lock:
            for r in self._regimes:
                if not site.startswith(r.prefix):
                    continue
                # before the clock site ever fires the clock reads 0: a
                # from_step=0 regime is live from the start
                now = self._regime_clock.get(r.clock_site, 0)
                if now < r.from_step or (r.until_step is not None and now >= r.until_step):
                    continue
                self.delivered.append(f"{site}@{step}")
                match = r
                break
        if match is None:
            return
        _notify_delivery(site, step)
        if match.kind == "latency":
            self.sleep(match.latency)
            return
        raise OSError(_REGIME_ERRNO[match.kind],
                      f"injected sustained {match.kind} regime [site={site} prefix={match.prefix}]")

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


def nan_armed(step: int) -> bool:
    """Is NaN poisoning armed for training step ``step``? Consumes it."""
    plan = _active
    return plan is not None and plan.consume_marker(_NAN_SITE, step)


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


# -- on-disk checkpoint damage (test control, not a hook) ----------------------


def _step_file(ckpt_dir: str, step: int) -> str:
    """A written step's data file (``training/checkpoint.py``'s layout:
    ``step-<N>.pt``, its manifest under ``manifests/``)."""
    path = os.path.join(ckpt_dir, f"step-{step:08d}.pt")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint step file {path}")
    return path


def corrupt_step(ckpt_dir: str, step: int) -> List[str]:
    """Flip bytes in the middle of a written step's data file -- the bit rot
    or torn write the manifest's per-leaf crc32 exists to catch (the
    manifest is left intact, so the verification is what finds it).
    Returns the files touched."""
    path = _step_file(ckpt_dir, step)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(min(64, size - size // 2))
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return [path]


def truncate_step(ckpt_dir: str, step: int) -> List[str]:
    """Truncate a written step's data file to half -- the preempted-mid-write
    failure (an incomplete step). Returns the files touched."""
    path = _step_file(ckpt_dir, step)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    return [path]


# -- on-disk session damage (test control, not a hook) -------------------------


def _session_gen_bin(session_dir: str, session_id: str, generation: Optional[int]) -> str:
    """Path of one session generation's payload file (default: the newest)."""
    d = os.path.join(session_dir, session_id)
    gens = sorted(int(n[len("gen-"):-len(".bin")]) for n in os.listdir(d)
                  if n.startswith("gen-") and n.endswith(".bin"))
    if not gens:
        raise FileNotFoundError(f"no session generations under {d}")
    g = generation if generation is not None else gens[-1]
    return os.path.join(d, f"gen-{g:06d}.bin")


def corrupt_session(session_dir: str, session_id: str,
                    generation: Optional[int] = None) -> str:
    """Flip bytes in the middle of a saved session generation's payload
    (default: the newest): the bit rot the manifest's per-leaf crc32 exists
    to catch. The restore falls back to the previous intact generation with
    a warning. A prefix entry has the same layout, with its key as the id.
    Returns the damaged path."""
    path = _session_gen_bin(session_dir, session_id, generation)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(min(64, size - size // 2))
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return path


def truncate_session(session_dir: str, session_id: str,
                     generation: Optional[int] = None) -> str:
    """Truncate a saved session generation's payload to half: the torn write
    a kill mid-save leaves when it lands between the payload rename and the
    manifest rename. Returns the damaged path."""
    path = _session_gen_bin(session_dir, session_id, generation)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    return path


__all__ = ["SITES", "SITE_PREFIXES", "REGIME_KINDS", "FaultPlan", "inject", "active", "fire",
           "nan_armed", "decode_nan_armed", "decode_slot_nan_armed", "known_site",
           "known_regime_prefix", "add_observer", "remove_observer", "corrupt_step",
           "truncate_step", "corrupt_session", "truncate_session"]
