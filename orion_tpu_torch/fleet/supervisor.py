"""Drain-and-respawn supervision for a replica fleet: the port's copy of
``orion_tpu/fleet/supervisor.py``.

The supervisor owns the replica set behind the router and enforces one
invariant: the fleet's serving capacity heals itself without losing a
conversation. Its loop is a plain poll (``tick``), so tests drive it
deterministically and production runs it on a thread:

- **heartbeat** — every tick polls each replica's ``status()`` (the
  server's atomic health+occupancy snapshot) with a timeout. A replica
  that misses ``miss_limit`` consecutive polls is presumed wedged: it is
  killed and respawned. Any committed session generations it held are on
  the SHARED store, so its conversations resume elsewhere.
- **degraded ⇒ drain-and-respawn** — a replica reporting DEGRADED (its
  ladder engaged, a watchdog tripped, a save failed) is SIGTERM-drained:
  in-flight sessionless work completes, resident sessions SUSPEND to the
  shared store (one O(1) snapshot each), the process exits 0 — then a
  fresh replica takes its slot in the router. In-flight conversations
  continue on the survivors with zero lost turns; nobody waits for the
  limping replica to limp through its backlog.
- **exit ⇒ respawn** — a replica that simply died (OOM-killed, crashed)
  is replaced; the router's failover already stopped sending it work the
  moment its channel broke.
- **persistent fast burn ⇒ drain-and-respawn** — a replica whose SLO
  fast-burn alert (the ``slo`` section of its status snapshot) fires for
  ``burn_limit`` consecutive heartbeats is treated like a degraded one:
  drained and replaced. This closes the gap the health state alone
  leaves open — a replica can flap SERVING ⇔ DEGRADED on every clean
  completion while its error budget burns steadily; the burn rate is the
  signal that doesn't flap. A fresh replica starts with a full budget.
- **spawn retries** — replica creation runs under the resilience retry
  layer with the ``fleet.replica_spawn`` hook inside the retried region,
  so a transient spawn failure (fork pressure, a slow filesystem) is a
  backoff, not a capacity loss.
- **elastic autoscaling** (opt-in via :class:`AutoscalePolicy`)
  — the same tick also runs a scale control loop over capacity headroom,
  queue depth and SLO burn, with double-ended hysteresis; scale-in
  drains its victim through the shared session store (zero lost turns)
  and :meth:`morph` rolls the whole fleet onto a new shape the same
  way.

Draining the LAST healthy replica is still correct — the router rejects
while nothing is routable and heals when the respawn reports ready — but
the supervisor replaces replicas one at a time precisely so that window
stays one replica wide.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Callable, List, Optional

from orion_tpu_torch.obs import cost as obs_cost
from orion_tpu_torch.obs import flight
from orion_tpu_torch.obs import metrics as obs_metrics
from orion_tpu_torch.resilience.inject import fire
from orion_tpu_torch.resilience.retry import RetryPolicy, call_with_retries

from orion_tpu_torch.fleet.replica import ReplicaHandle
from orion_tpu_torch.fleet.router import Router


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """When the supervisor may move N. Three pressure
    signals, every one read from state the tick's own heartbeats just
    refreshed (the autoscaler never issues an extra status RPC):

    - **capacity headroom** — ``fleet_capacity`` recomputed over the
      live replicas' registry snapshots; below ``scale_out_headroom``
      the fleet is near its measured ceiling, above
      ``scale_in_headroom`` it is paying for idle replicas.
    - **queue depth** — fleet in-flight per live replica against
      ``queue_high`` (pressure) / ``queue_low`` (surplus); 0 disarms
      the signal. This is the LEADING signal: a step-function load
      doubling shows up in the admission queues a full capacity-window
      before the tokens/s gauges move.
    - **fast burn** — any replica's SLO fast-burn alert firing counts
      as pressure (more capacity is the first response to a latency
      burn) and vetoes surplus; burn never votes scale-in.

    Hysteresis is double-ended: pressure must persist ``up_ticks``
    consecutive ticks before a spawn, surplus ``down_ticks`` before a
    drain (asymmetric on purpose — adding capacity late costs latency,
    removing it early costs a respawn), and every move starts a
    ``cooldown_ticks`` refractory window so the loop measures the NEW
    fleet before moving again (a fresh replica's first heartbeats carry
    empty windows that would otherwise read as surplus).

    Scale-in is loss-free by construction: the victim (least-loaded) is
    removed from the router FIRST (no new dispatch can race onto it),
    then SIGTERM-drained — in-flight work completes, resident sessions
    suspend to the shared store, and their conversations resume on the
    survivors. Zero lost turns, same contract as a drain-respawn."""

    min_replicas: int = 1
    max_replicas: int = 8
    scale_out_headroom: float = 0.15
    scale_in_headroom: float = 0.60
    queue_high: float = 0.0  # in-flight per live replica; 0 = disarmed
    queue_low: float = 0.0
    up_ticks: int = 2
    down_ticks: int = 5
    cooldown_ticks: int = 5


class Supervisor:
    """Spawns ``n`` replicas via ``factory(name)`` (must return a STARTED
    handle), builds the router over them, and heals the set on
    :meth:`tick` (or the :meth:`start_monitor` thread)."""

    def __init__(
        self,
        factory: Callable[[str], ReplicaHandle],
        n: int,
        *,
        max_inflight: int = 0,
        heartbeat_timeout: float = 5.0,
        miss_limit: int = 3,
        burn_limit: int = 3,
        drain_grace: float = 30.0,
        ready_timeout: float = 240.0,
        spawn_retry: Optional[RetryPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
        tracer=None,
        autoscale: Optional[AutoscalePolicy] = None,
    ):
        assert n >= 1, n
        self.factory = factory
        self.n = int(n)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.miss_limit = int(miss_limit)
        self.burn_limit = int(burn_limit)
        self.drain_grace = float(drain_grace)
        self.ready_timeout = float(ready_timeout)
        self.spawn_retry = (
            spawn_retry if spawn_retry is not None else RetryPolicy(attempts=3)
        )
        self._clock = clock
        self._tracer = tracer
        self._max_inflight = int(max_inflight)
        self._spawn_count = 0  # fleet.replica_spawn's step address
        self._misses: dict = {}
        self._burns: dict = {}  # consecutive fast-burn heartbeats
        self._suppressed: set = set()  # store-outage respawns suppressed
        self.autoscale = autoscale
        self._up_streak = 0  # consecutive pressure ticks
        self._down_streak = 0  # consecutive surplus ticks
        self._cooldown = 0  # refractory ticks left after a move
        self._last_signals: dict = {}  # last tick's evaluated signals
        self.replicas: List[ReplicaHandle] = []
        self.router: Optional[Router] = None
        self.events: List[tuple] = []  # (t, replica name, what) audit log
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Supervisor":
        self.replicas = [self._spawn(i) for i in range(self.n)]
        self.router = Router(
            self.replicas, max_inflight=self._max_inflight,
            clock=self._clock, tracer=self._tracer,
        )
        # the router holds the SAME list object; replacements mutate it
        self.replicas = self.router.replicas
        return self

    @staticmethod
    def replica_index(name: str) -> int:
        """The replica SLOT index encoded in a factory name
        (``replica-{idx}.g{spawn}``) — stable across respawns, so
        factories can key per-slot resources (e.g. a pinned compute
        core) off it without re-parsing the format themselves."""
        return int(name.split("-")[1].split(".")[0])

    def _spawn(self, idx: int) -> ReplicaHandle:
        def make() -> ReplicaHandle:
            self._spawn_count += 1
            fire("fleet.replica_spawn", step=self._spawn_count)
            replica = self.factory(f"replica-{idx}.g{self._spawn_count}")
            try:
                replica.wait_ready(self.ready_timeout)
            except Exception:
                replica.kill()
                replica.join(timeout=10.0)
                raise
            return replica

        replica = call_with_retries(
            make, self.spawn_retry, describe=f"replica {idx} spawn"
        )
        self._event(replica.name, "spawned")
        return replica

    def _event(self, name: str, what: str) -> None:
        self.events.append((self._clock(), name, what))
        # the supervision audit log doubles as black-box context: every
        # spawn/drain/kill/heartbeat-miss lands in the default flight
        # ring beside the control ops and fault deliveries
        flight.record("supervisor", replica=name, what=what)
        print(f"[fleet] {name}: {what}", file=sys.stderr)

    # -- healing --------------------------------------------------------------

    def tick(self) -> None:
        """One supervision pass over every replica. Safe to call from a
        monitor thread or directly from a test."""
        for idx, replica in enumerate(list(self.replicas)):
            if replica is not self.replicas[idx]:
                continue  # replaced mid-iteration
            if not replica.alive:
                self._event(replica.name, "exited; respawning")
                replica.join(timeout=1.0)
                self._replace(idx, replica)
                continue
            status = replica.status(timeout=self.heartbeat_timeout)
            if status is None:
                misses = self._misses.get(replica.name, 0) + 1
                self._misses[replica.name] = misses
                self._event(
                    replica.name, f"heartbeat missed ({misses}/{self.miss_limit})"
                )
                if misses >= self.miss_limit:
                    self._event(replica.name, "presumed wedged; killing")
                    replica.kill()
                    replica.join(timeout=10.0)
                    self._replace(idx, replica)
                continue
            self._misses[replica.name] = 0
            state = status.get("state")
            reason = str(status.get("reason") or "")
            if not (state == "degraded"
                    and reason.startswith("store-outage:")):
                self._suppressed.discard(replica.name)  # episode over
            if state == "degraded" and reason.startswith("store-outage:"):
                # a replica DEGRADED because a SHARED store's breaker is
                # open must NOT be drained-and-respawned: a fresh
                # process meets the same dead store, minus this one's
                # resident sessions — the dirty write-behind copies that
                # are the ONLY up-to-date turns during the outage. A
                # drain here is how "store blip" becomes "lost turns".
                # Leave it serving (prefix = cold prefill, sessions =
                # write-behind); the router already deprioritizes it.
                if replica.name not in self._suppressed:
                    # once per outage episode, not per heartbeat — the
                    # audit log names the decision, the breaker's own
                    # transitions carry the play-by-play
                    self._suppressed.add(replica.name)
                    self._event(
                        replica.name, f"respawn_suppressed ({reason})"
                    )
            elif state == "degraded":
                self._drain_respawn(idx, replica, "degraded")
            elif state == "dead":
                self._event(replica.name, "reports dead; respawning")
                replica.join(timeout=1.0)
                self._replace(idx, replica)
            else:
                # SLO actuation, healing half: a replica can flap
                # SERVING <-> DEGRADED on every clean completion while
                # its error budget burns steadily — the fast-burn alert
                # in the status snapshot is the non-flapping signal. A
                # burn that persists across burn_limit consecutive
                # heartbeats gets the degraded treatment: drain (its
                # sessions suspend to the shared store) and respawn
                # with a fresh error budget. With default
                # slo_degrade_ticks the server usually latches itself
                # DEGRADED within a few boundaries and the branch
                # above acts first — this path is the backstop for
                # replicas configured not to self-degrade (large
                # slo_degrade_ticks) or whose health recovered while
                # the budget kept burning. Gated on the replica's
                # "actuate" bit (declared objectives only): the
                # observe-only defaults report burn but must never buy
                # a drain-respawn the operator didn't define "bad" for
                # — under fleet-wide overload that would churn healthy
                # capacity exactly when it is scarcest.
                # (availability is excluded like the server's own
                # actuation: its bad events are sheds/rejects — the
                # fleet's admission decisions — and respawning a
                # saturated replica for shedding would churn capacity
                # under the very overload that caused the sheds)
                slo = status.get("slo") or {}
                firing = [
                    n for n in (slo.get("firing_fast") or [])
                    if (slo.get("objectives") or {}).get(n, {}).get("kind")
                    != "availability"
                ] if slo.get("actuate") else []
                if firing:
                    burns = self._burns.get(replica.name, 0) + 1
                    self._burns[replica.name] = burns
                    self._event(
                        replica.name,
                        f"slo fast burn {','.join(firing)} "
                        f"({burns}/{self.burn_limit})",
                    )
                    if burns >= self.burn_limit:
                        self._drain_respawn(
                            idx, replica, "slo fast burn persisted"
                        )
                else:
                    self._burns[replica.name] = 0
        if self.autoscale is not None and self.router is not None:
            self._autoscale_tick()

    def _drain_respawn(self, idx: int, replica: ReplicaHandle,
                       why: str) -> None:
        """SIGTERM-drain ``replica`` (its sessions suspend to the shared
        store), wait out the grace, escalate to kill, respawn fresh."""
        self._event(replica.name, f"{why}; draining")
        replica.drain()
        if not replica.join(timeout=self.drain_grace):
            self._event(replica.name, "drain overran grace; killing")
            replica.kill()
            replica.join(timeout=10.0)
        self._replace(idx, replica)

    def _replace(self, idx: int, old: ReplicaHandle) -> None:
        self._misses.pop(old.name, None)
        self._burns.pop(old.name, None)
        self._suppressed.discard(old.name)
        new = self._spawn(idx)
        # only reachable via tick()/_drain_respawn(), i.e. after start()
        # built the router (the replicas list IS the router's list)
        assert self.router is not None
        self.router.replace(old, new)

    # -- elastic autoscaling ---------------------------------------------------

    def _autoscale_tick(self) -> None:
        """One control-loop pass: evaluate the three pressure signals
        against the policy, advance the hysteresis streaks, and move N
        by AT MOST one replica. Everything here reads the heartbeat
        snapshots this tick already refreshed — the autoscaler adds
        zero control-channel traffic."""
        pol = self.autoscale
        alive = [r for r in self.replicas if r.alive]
        n_live = len(alive)
        snaps = [
            s for s in (getattr(r, "last_status", None) for r in alive) if s
        ]
        metrics = [s["metrics"] for s in snaps if s.get("metrics")]
        headroom = None
        if metrics:
            cap = obs_cost.fleet_capacity(obs_metrics.aggregate(metrics))
            if not cap.get("no_data"):
                headroom = cap["headroom"]
        inflight = sum(r.inflight for r in alive)
        queue_pressure = (
            pol.queue_high > 0 and n_live > 0
            and inflight >= pol.queue_high * n_live
        )
        queue_surplus = (
            pol.queue_high > 0 and inflight <= pol.queue_low * n_live
        )
        burn_pressure = any(
            bool((s.get("slo") or {}).get("firing_fast")) for s in snaps
        )
        pressure = queue_pressure or burn_pressure or (
            headroom is not None and headroom < pol.scale_out_headroom
        )
        surplus = not pressure and (
            (headroom is not None and headroom > pol.scale_in_headroom)
            or (headroom is None and queue_surplus)
        )
        if pressure:
            self._up_streak += 1
            self._down_streak = 0
        elif surplus:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        self._last_signals = {
            "headroom": headroom, "inflight": inflight, "live": n_live,
            "queue_pressure": queue_pressure, "burn_pressure": burn_pressure,
            "pressure": pressure, "surplus": surplus,
            "up_streak": self._up_streak, "down_streak": self._down_streak,
            "cooldown": self._cooldown,
        }
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        if (pressure and self._up_streak >= pol.up_ticks
                and n_live < pol.max_replicas):
            why = ("queue" if queue_pressure
                   else "burn" if burn_pressure else "headroom")
            self._scale_out(why)
        elif (surplus and self._down_streak >= pol.down_ticks
                and n_live > pol.min_replicas):
            self._scale_in()

    def _scale_out(self, why: str) -> None:
        """Spawn one replica into a FRESH slot index (max existing + 1:
        scale-in may have left holes and a reused name would alias
        per-slot resources like a pinned core) and add it to the
        router's candidate set."""
        idx = max(
            (self.replica_index(r.name) for r in self.replicas), default=-1
        ) + 1
        new = self._spawn(idx)
        assert self.router is not None
        self.router.add(new)
        self.n = len(self.router.replicas)
        self._cooldown = self.autoscale.cooldown_ticks
        self._up_streak = self._down_streak = 0
        self._event(new.name, f"scale_out ({why})")

    def _scale_in(self) -> None:
        """Retire the least-loaded replica, loss-free: remove it from
        the router FIRST (no new dispatch can land on it), then drain —
        in-flight work completes and resident sessions suspend to the
        shared store, where the survivors resume them. Ties break
        toward the HIGHEST slot index so the fleet shrinks from the
        top and slot-keyed resources stay dense."""
        alive = [r for r in self.replicas if r.alive]
        if not alive:
            return
        victim = min(
            alive,
            key=lambda r: (r.inflight, -self.replica_index(r.name)),
        )
        assert self.router is not None
        self.router.remove(victim)
        self.n = len(self.router.replicas)
        self._cooldown = self.autoscale.cooldown_ticks
        self._up_streak = self._down_streak = 0
        self._event(victim.name, "scale_in; draining")
        victim.drain()
        if not victim.join(timeout=self.drain_grace):
            self._event(victim.name, "scale_in drain overran grace; killing")
            victim.kill()
            victim.join(timeout=10.0)
        self._misses.pop(victim.name, None)
        self._burns.pop(victim.name, None)
        self._suppressed.discard(victim.name)

    def autoscale_state(self) -> dict:
        """The control loop's last evaluated signals + streaks — the
        debug view a bench or /statusz consumer reads to see WHY the
        fleet did (or didn't) move."""
        return dict(self._last_signals)

    def morph(self, factory: Callable[[str], ReplicaHandle],
              *, why: str = "morph") -> None:
        """Footprint morphing: swap EVERY replica to the shape the new
        ``factory`` builds (different slots/chunk) by
        rolling drain-respawn — one replica at a time, so the routable
        window never shrinks by more than one. Mid-conversation safety
        rides the session store's portability contract: the suspended
        carry row is logical (footprint-free), so a session suspended
        on the old shape resumes BITWISE on the new one (a qmode flip
        changes the weights identity and is NOT migration-safe — spell
        it as a new fleet). The new
        factory also becomes the respawn/scale-out factory: every
        future replica is born the new shape."""
        self.factory = factory
        for idx, replica in enumerate(list(self.replicas)):
            if replica is not self.replicas[idx]:
                continue  # replaced mid-roll
            self._drain_respawn(idx, replica, why)

    # -- fleet-level observability --------------------------------------------

    def aggregate_metrics(self) -> dict:
        """ONE fleet-level metrics view from every live replica's
        registry, scraped over the existing line-JSON ``status`` op (the
        Server's snapshot carries its registry): counters
        and histograms sum, gauges add across replicas, and the raw
        per-replica snapshots ride in ``by_source``. A replica that
        misses the scrape is simply absent — aggregation must not block
        on a wedged child longer than the heartbeat timeout."""
        snaps, names = [], []
        for replica in list(self.replicas):
            status = replica.status(timeout=self.heartbeat_timeout)
            if status is None:
                status = getattr(replica, "last_status", None)
            if status is None:
                continue
            m = status.get("metrics")
            if m is None:
                continue
            snaps.append(m)
            names.append(replica.name)
        agg = obs_metrics.aggregate(snaps, sources=names)
        agg["replicas"] = len(names)
        # the ONE capacity figure a scale-out decision keys on:
        # headroom recomputed from the SUMMED ceiling/current gauges —
        # the per-replica headroom FRACTIONS also sum in the gauge
        # rollup above, which is meaningless; this section is the
        # number the autoscaler reads
        agg["capacity"] = obs_cost.fleet_capacity(agg)
        return agg

    # -- monitor thread -------------------------------------------------------

    def start_monitor(self, interval: float = 1.0) -> None:
        assert self._monitor is None, "monitor already running"
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(timeout=interval):
                try:
                    self.tick()
                except Exception as e:  # supervision must outlive one bad tick
                    print(f"[fleet] tick failed: {type(e).__name__}: {e}",
                          file=sys.stderr)

        self._monitor = threading.Thread(
            target=run, name="fleet-monitor", daemon=True
        )
        self._monitor.start()

    def stop_monitor(self) -> None:
        """Stop the monitor thread. A tick in flight may be respawning a
        replica (bounded by ``ready_timeout`` a try): wait it out, so the
        new child joins ``replicas`` before a drain walks them and is never
        left running behind the fleet."""
        if self._monitor is None:
            return
        self._stop.set()
        self._monitor.join(timeout=max(10.0, self.ready_timeout + 10.0))
        self._monitor = None

    # -- shutdown -------------------------------------------------------------

    def drain_all(self, timeout: float = 60.0) -> None:
        """Graceful fleet shutdown: drain every replica concurrently,
        escalate stragglers to kill after ``timeout``."""
        self.stop_monitor()
        for replica in self.replicas:
            replica.drain()
        deadline = self._clock() + timeout
        for replica in self.replicas:
            left = max(deadline - self._clock(), 0.1)
            if not replica.join(timeout=left):
                self._event(replica.name, "drain timeout; killing")
                replica.kill()
                replica.join(timeout=10.0)

    def kill_all(self) -> None:
        self.stop_monitor()
        for replica in self.replicas:
            replica.kill()
            replica.join(timeout=10.0)


__all__ = ["AutoscalePolicy", "Supervisor"]
