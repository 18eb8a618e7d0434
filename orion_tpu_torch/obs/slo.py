"""SLO engine: windowed quantiles, error budgets, burn-rate alerts. The
port's copy of ``orion_tpu/obs/slo.py``, whole (it imports no jax and no
torch).

The metrics registry records *lifetime* counters and histograms — the right
artifact for a post-mortem, the wrong input for a control loop: a replica
that served a million fast turns and is slow NOW still shows a great
lifetime p99. This module closes that gap with three pieces, all pure
host code (nothing here imports torch, reads the card, or blocks
unboundedly):

- **interpolated quantiles** (:func:`quantile_from_counts`) over the
  fixed-bucket :class:`~orion_tpu_torch.obs.metrics.Histogram`: linear
  interpolation inside the bucket containing the target rank, exact to
  within one bucket width (property-tested against ``numpy.percentile``
  in the JAX package's tests/test_obs.py). The ``+Inf`` overflow bucket
  clamps to the last finite bound — an estimator must never invent a number beyond what the
  histogram resolved.
- **windowed views** (:class:`WindowedHistogram`, and the generic
  :class:`SnapshotRing` under it): a bounded ring of timestamped
  CUMULATIVE snapshots, ticked at chunk boundaries with an injectable
  clock; the view over the last W seconds is one vector subtraction
  (current minus the newest snapshot at least W old). Early in life the
  window falls back to "since birth" and reports its actual span.
- **the SLOEngine**: declarative :class:`Objective` s — per-turn (or
  per-chunk) latency, error rate, availability — each with an error
  budget (``1 - target``) and the SRE literature's multi-window
  burn-rate alerts. ``burn = bad_fraction / budget``: burn 1.0 spends
  the budget exactly at the sustainable rate; the FAST alert fires when
  the fast window burns at >= ``fast_burn`` AND the slow window is
  burning too (>= 1.0 — the long window confirms it is not a blip that
  already recovered); the SLOW alert fires on ``slow_burn`` over the
  slow window alone. Evaluation happens at chunk boundaries on the host
  thread — the O(1)-state dividend: a full SLO control loop costs zero
  reads of the card.

The actuation consumers (see serving/server.py, fleet/router.py,
fleet/supervisor.py): sustained fast burn degrades the server's health
and sheds admissions earlier; the router's least-loaded sort tie-breaks
on (fast-burn firing, windowed p99) so traffic shifts away from a slow
replica BEFORE it goes unhealthy; the supervisor drain-and-respawns a
replica whose fast burn persists.

Tooling: ``python -m orion_tpu_torch.obs.slo check --objectives obj.json
metrics.prom.json`` evaluates a dumped registry snapshot
(:meth:`MetricsRegistry.dump`'s ``.json`` sibling) against declared
objectives and exits nonzero on violation.

Metric-name conventions (what the readers look for): latency objectives
read the ``turn_latency_ms`` (``source="turn"``) or ``chunk_ms``
(``source="chunk"``) histogram; error rate scores ``failed`` +
``deadline`` against ``ok``; availability scores ``shed`` + ``rejected``
against ``admitted``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# metric-name conventions (the serving layer's vocabulary; the CLI and
# registry_readers share them so a dumped snapshot checks identically)
LATENCY_SOURCES = {"turn": "turn_latency_ms", "chunk": "chunk_ms"}
ERROR_GOOD = ("ok",)
ERROR_BAD = ("failed", "deadline")
AVAIL_GOOD = ("admitted",)
AVAIL_BAD = ("shed", "rejected")

_KINDS = ("latency", "error_rate", "availability")


def _norm_bound(b):
    """Histogram bucket bounds arrive as numbers or the snapshot's
    serialized ``"+Inf"`` string; normalize to a comparable number."""
    if b == "+Inf" or b is None:
        return math.inf
    return b


def quantile_from_counts(
    buckets: Sequence, counts: Sequence, q: float
) -> Optional[float]:
    """Interpolated ``q``-quantile (0 <= q <= 1) of a fixed-bucket
    histogram cell: ``buckets`` are ascending upper bounds (the last may
    be ``inf`` / ``"+Inf"``), ``counts`` are per-bucket counts (NOT
    cumulative — exactly a :meth:`Histogram.cell`'s ``counts`` list, or
    a windowed delta of one).

    Linear interpolation of the target rank inside its bucket, with the
    first bucket's lower edge at 0 (latencies; the registry's histograms
    are all nonnegative). The overflow bucket clamps to the last finite
    bound — the histogram did not resolve anything beyond it, and an SLO
    comparison against an invented larger number would false-alarm.
    Returns None for an empty cell."""
    total = sum(counts)
    if total <= 0:
        return None
    bounds = [_norm_bound(b) for b in buckets]
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if c <= 0 or cum < target:
            continue
        lo = bounds[i - 1] if i > 0 else 0.0
        hi = bounds[i]
        if hi == math.inf:
            return lo if lo != math.inf else 0.0
        frac = (target - prev_cum) / c if target > prev_cum else 0.0
        return lo + frac * (hi - lo)
    # target beyond every count (q == 1 with trailing zeros): the last
    # nonempty bucket's upper bound, clamped as above
    last = None
    for i, c in enumerate(counts):
        if c > 0:
            last = i
    if last is None:
        return None
    hi = bounds[last]
    if hi == math.inf:
        lo = bounds[last - 1] if last > 0 else 0.0
        return lo if lo != math.inf else 0.0
    return hi


def split_at_threshold(
    buckets: Sequence, counts: Sequence, threshold: float
) -> Tuple[float, float]:
    """(good, bad) event counts relative to a latency threshold, with
    linear interpolation inside the straddling bucket. Events in the
    overflow bucket are all bad (nothing in it is known <= any finite
    threshold)."""
    bounds = [_norm_bound(b) for b in buckets]
    good = 0.0
    total = 0.0
    for i, c in enumerate(counts):
        total += c
        if c <= 0:
            continue
        lo = bounds[i - 1] if i > 0 else 0.0
        hi = bounds[i]
        if hi <= threshold:
            good += c
        elif lo < threshold and hi != math.inf:
            good += c * (threshold - lo) / (hi - lo)
    return good, total - good


class SnapshotRing:
    """Bounded ring of timestamped CUMULATIVE value vectors; the rolling
    window over the last W seconds is ``current - snapshot(>= W old)``.
    The owner reads the live values itself (under whatever lock owns
    them) and hands plain tuples in — the ring never calls out, so it
    can never participate in a lock-order cycle."""

    def __init__(self, slice_s: float, keep_s: float):
        assert slice_s > 0 and keep_s >= slice_s, (slice_s, keep_s)
        self.slice_s = slice_s
        cap = math.ceil(keep_s / slice_s) + 2
        self._ring: deque = deque(maxlen=cap)

    def note(self, t: float, vec: Tuple) -> None:
        """Record one cumulative snapshot; coalesces to one per slice."""
        if self._ring and t - self._ring[-1][0] < self.slice_s:
            return
        self._ring.append((t, vec))

    def delta(self, t: float, vec: Tuple, window_s: float):
        """``(vec - snapshot at least window_s old, actual_window_s)``.
        With no snapshot that old yet, the OLDEST one anchors the delta
        (a young window reports its true, shorter span); with an empty
        ring the delta is zero over zero seconds."""
        base_t, base = None, None
        for st, sv in self._ring:
            if t - st >= window_s:
                base_t, base = st, sv
            else:
                break
        if base is None:
            if not self._ring:
                return tuple(0 for _ in vec), 0.0
            base_t, base = self._ring[0]
        return tuple(a - b for a, b in zip(vec, base)), t - base_t


class WindowedHistogram:
    """Rolling-window quantile view over one cumulative fixed-bucket
    histogram cell: ``read()`` must return the per-bucket counts tuple
    (host numbers, already concretized); :meth:`tick` snapshots it into
    the ring at ``slice_s`` granularity; :meth:`quantile` interpolates
    pXX over the last ``window_s`` seconds' deltas."""

    def __init__(
        self,
        buckets: Sequence,
        read: Callable[[], Tuple],
        clock: Callable[[], float] = time.monotonic,
        slice_s: float = 1.0,
        keep_s: float = 120.0,
    ):
        self.buckets = tuple(buckets)
        self._read = read
        self._clock = clock
        self._ring = SnapshotRing(slice_s, keep_s)

    def tick(self) -> None:
        self._ring.note(self._clock(), tuple(self._read()))

    def window(self, window_s: float):
        """(per-bucket count deltas, actual_window_s) for the last
        ``window_s`` seconds."""
        return self._ring.delta(self._clock(), tuple(self._read()), window_s)

    def quantile(self, q: float, window_s: float) -> Optional[float]:
        counts, _ = self.window(window_s)
        return quantile_from_counts(self.buckets, counts, q)


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative SLO. ``target`` is the promised good-event
    fraction (0.99 = "99% of events are good"); the error budget is
    ``1 - target``. ``kind``:

    - ``latency`` — an event is good when it completed under
      ``latency_ms``; ``source`` picks the histogram (``turn`` =
      per-turn request latency, ``chunk`` = per-boundary scan time — the
      signal that keeps reporting while a slow replica is mid-request).
    - ``error_rate`` — good = ``ok``, bad = ``failed`` + ``deadline``.
    - ``availability`` — good = ``admitted``, bad = ``shed`` +
      ``rejected``.
    """

    name: str
    kind: str
    target: float = 0.99
    latency_ms: float = 0.0
    source: str = "turn"  # latency only: turn | chunk
    fast_window_s: float = 5.0
    slow_window_s: float = 60.0
    fast_burn: float = 14.0
    slow_burn: float = 2.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"objective {self.name!r}: unknown kind {self.kind!r} "
                f"(one of {_KINDS})"
            )
        if self.kind == "latency":
            if self.latency_ms <= 0:
                raise ValueError(
                    f"latency objective {self.name!r} needs latency_ms > 0"
                )
            if self.source not in LATENCY_SOURCES:
                raise ValueError(
                    f"latency objective {self.name!r}: source must be one "
                    f"of {tuple(LATENCY_SOURCES)}"
                )
        if not (0.0 < self.target < 1.0):
            raise ValueError(
                f"objective {self.name!r}: target must be in (0, 1)"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def default_objectives() -> List[Objective]:
    """Observe-only defaults every server evaluates when nothing is
    configured: error-rate and availability at 99%. No latency objective
    by default — a latency bound is a deployment choice (model size,
    hardware, chunk), not something the engine can guess."""
    return [
        Objective(name="error_rate", kind="error_rate", target=0.99),
        Objective(name="availability", kind="availability", target=0.99),
    ]


def registry_readers(registry) -> Dict[str, Tuple]:
    """The standard serving readers over a
    :class:`~orion_tpu_torch.obs.metrics.MetricsRegistry`, keyed the way
    :class:`SLOEngine` looks them up: ``latency:turn`` / ``latency:chunk``
    map to ``(buckets, read_counts)``, ``error_rate`` / ``availability``
    to ``read_good_bad``. Every read takes the registry lock once and
    returns plain host numbers."""
    readers: Dict[str, Tuple] = {}
    for source, hist_name in LATENCY_SOURCES.items():
        h = registry.histogram(hist_name)

        def read_counts(h=h):
            # label-agnostic: chunk_ms cells may carry a footprint
            # label; the objective windows the instrument, not one cell
            cell = h.cell_total()
            if cell is None:
                return (0,) * len(h.buckets)
            return tuple(cell["counts"])

        readers[f"latency:{source}"] = (h.buckets, read_counts)

    def counter_pair(good_names, bad_names):
        def read():
            flat = registry.counters_flat()
            return (
                sum(flat.get(n, 0) for n in good_names),
                sum(flat.get(n, 0) for n in bad_names),
            )

        return read

    readers["error_rate"] = counter_pair(ERROR_GOOD, ERROR_BAD)
    readers["availability"] = counter_pair(AVAIL_GOOD, AVAIL_BAD)
    return readers


class SLOEngine:
    """Evaluates a set of :class:`Objective` s at chunk boundaries.

    Locking: :meth:`tick` reads every objective's cumulative values FIRST
    (under the reader's own lock — for the serving wiring that is the
    Server's stats lock), then updates rings and recomputes state under
    the engine's private lock. The two locks are never held together, so
    a scraping thread calling :meth:`state` while the scheduler holds the
    stats lock can never deadlock. :meth:`state` returns the last
    computed payload without touching any reader."""

    def __init__(
        self,
        objectives: Sequence[Objective],
        readers: Dict[str, Tuple],
        clock: Callable[[], float] = time.monotonic,
        slice_s: Optional[float] = None,
    ):
        self.objectives = list(objectives)
        if not self.objectives:
            raise ValueError("SLOEngine needs at least one objective")
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self._clock = clock
        if slice_s is None:
            fastest = min(o.fast_window_s for o in self.objectives)
            slice_s = max(0.05, fastest / 4.0)
        self.slice_s = slice_s
        self._lock = threading.Lock()
        self._per: List[Tuple[Objective, object, object, object]] = []
        for obj in self.objectives:
            if obj.kind == "latency":
                key = f"latency:{obj.source}"
                got = readers.get(key)
                if got is None:
                    raise ValueError(
                        f"objective {obj.name!r} needs reader {key!r}"
                    )
                buckets, read = got
                buckets = tuple(_norm_bound(b) for b in buckets)
                finite = [b for b in buckets if b != math.inf]
                if finite and obj.latency_ms >= finite[-1]:
                    # the histogram cannot resolve this threshold:
                    # every overflow-bucket event would count BAD even
                    # when it meets the SLO, so a model whose normal
                    # turns exceed the last finite bound would burn at
                    # 100x and churn itself forever. Refuse loudly at
                    # declaration instead of false-alarming in
                    # production.
                    raise ValueError(
                        f"objective {obj.name!r}: latency_ms "
                        f"{obj.latency_ms:g} is at/beyond the "
                        f"histogram's last finite bucket bound "
                        f"({finite[-1]:g} ms) — events above it are "
                        "unresolvable and would all score bad; widen "
                        "the histogram buckets or lower the objective"
                    )
            else:
                read = readers.get(obj.kind)
                if read is None:
                    raise ValueError(
                        f"objective {obj.name!r} needs reader {obj.kind!r}"
                    )
                buckets = None
            keep = max(o.slow_window_s for o in self.objectives) * 1.5
            ring = SnapshotRing(slice_s, max(keep, slice_s * 4))
            self._per.append((obj, buckets, read, ring))
        self._state: dict = {
            "t": clock(), "objectives": {},
            "firing_fast": [], "firing_slow": [],
            "p99_ms": None, "worst_burn_fast": 0.0,
        }

    # -- evaluation ------------------------------------------------------------

    @staticmethod
    def _good_bad(obj: Objective, buckets, vec) -> Tuple[float, float]:
        if obj.kind == "latency":
            return split_at_threshold(buckets, vec, obj.latency_ms)
        return vec[0], vec[1]

    def tick(self) -> dict:
        """One chunk-boundary evaluation: snapshot every objective's
        cumulative values into its ring, recompute burn rates/alerts/
        budgets, publish (and return) the new state payload."""
        now = self._clock()
        vals = [tuple(read()) for _, _, read, _ in self._per]
        with self._lock:
            out = {
                "t": now, "objectives": {},
                "firing_fast": [], "firing_slow": [],
                "p99_ms": None, "worst_burn_fast": 0.0,
            }
            for (obj, buckets, _, ring), vec in zip(self._per, vals):
                ring.note(now, vec)
                fast_d, fast_w = ring.delta(now, vec, obj.fast_window_s)
                slow_d, slow_w = ring.delta(now, vec, obj.slow_window_s)

                def burn(delta):
                    good, bad = self._good_bad(obj, buckets, delta)
                    total = good + bad
                    if total <= 0:
                        return 0.0, 0.0
                    return (bad / total) / obj.budget, total

                burn_fast, n_fast = burn(fast_d)
                burn_slow, n_slow = burn(slow_d)
                # the multi-window discipline: the fast window detects,
                # the slow window confirms the budget is really burning
                # (>= 1.0 = faster than sustainable) — a blip that
                # already recovered can't page
                fast_firing = (
                    burn_fast >= obj.fast_burn and burn_slow >= 1.0
                )
                slow_firing = burn_slow >= obj.slow_burn
                life_good, life_bad = self._good_bad(obj, buckets, vec)
                life_total = life_good + life_bad
                consumed = (
                    (life_bad / life_total) / obj.budget
                    if life_total > 0 else 0.0
                )
                row = {
                    "kind": obj.kind, "target": obj.target,
                    "burn_fast": round(burn_fast, 3),
                    "burn_slow": round(burn_slow, 3),
                    "window_fast_s": round(fast_w, 3),
                    "window_slow_s": round(slow_w, 3),
                    "events_fast": n_fast, "events_slow": n_slow,
                    "fast_firing": fast_firing,
                    "slow_firing": slow_firing,
                    "budget_remaining": round(max(0.0, 1.0 - consumed), 4),
                    "events_total": life_total,
                }
                if obj.kind == "latency":
                    row["latency_ms"] = obj.latency_ms
                    row["p99_ms"] = quantile_from_counts(
                        buckets, slow_d, 0.99
                    )
                    row["p50_ms"] = quantile_from_counts(
                        buckets, slow_d, 0.50
                    )
                    if out["p99_ms"] is None and row["p99_ms"] is not None:
                        out["p99_ms"] = round(row["p99_ms"], 3)
                out["objectives"][obj.name] = row
                if fast_firing:
                    out["firing_fast"].append(obj.name)
                if slow_firing:
                    out["firing_slow"].append(obj.name)
                out["worst_burn_fast"] = max(
                    out["worst_burn_fast"], round(burn_fast, 3)
                )
            self._state = out
            return out

    def state(self) -> dict:
        """The last :meth:`tick`'s payload (the /slo body and the
        ``snapshot()["slo"]`` section) — never calls a reader, so scrape
        threads can read it regardless of what the scheduler holds."""
        with self._lock:
            return self._state


# -- static evaluation of a dumped snapshot (the CI gate) ----------------------


def _snapshot_counters(snap: dict) -> Dict[str, object]:
    out = {}
    for row in snap.get("counters", ()):
        if not row.get("labels"):
            out[row["name"]] = row["value"]
    return out


def _snapshot_histogram(snap: dict, name: str) -> Optional[dict]:
    """All of ``name``'s label cells summed (the snapshot-side twin of
    ``Histogram.cell_total``): chunk_ms cells may carry a ``tp`` label,
    and a lifetime check over a dump must see the same totals
    the live readers window."""
    out: Optional[dict] = None
    for row in snap.get("histograms", ()):
        if row["name"] != name:
            continue
        if out is None:
            out = {"name": name, "buckets": row.get("buckets"),
                   "counts": list(row["counts"]), "sum": row["sum"],
                   "count": row["count"]}
        else:
            for i, c in enumerate(row["counts"]):
                out["counts"][i] += c
            out["sum"] += row["sum"]
            out["count"] += row["count"]
    return out


def check_snapshot(
    objectives: Sequence[Objective], snap: dict
) -> Tuple[List[dict], bool]:
    """Evaluate a dumped registry snapshot (the ``.json`` sibling of
    :meth:`MetricsRegistry.dump`) against ``objectives`` over its whole
    LIFETIME (a static dump has no windows). Returns (per-objective
    report rows, ok). An objective with zero events passes with
    ``"no_data"`` — absence of evidence is not a violation, and a bench
    gate must not fail on a run that never exercised a path."""
    rows: List[dict] = []
    ok = True
    counters = _snapshot_counters(snap)
    for obj in objectives:
        row: dict = {"name": obj.name, "kind": obj.kind,
                     "target": obj.target}
        if obj.kind == "latency":
            hist = _snapshot_histogram(snap, LATENCY_SOURCES[obj.source])
            row["latency_ms"] = obj.latency_ms
            if hist is None:
                good, bad = 0.0, 0.0
            else:
                bounds = [_norm_bound(b) for b in hist["buckets"]]
                finite = [b for b in bounds if b != math.inf]
                if finite and obj.latency_ms >= finite[-1]:
                    # same resolvability rule as the live engine: the
                    # gate must not fail (or pass) on events the
                    # histogram cannot place against the threshold
                    row.update(status="unresolvable",
                               events=sum(hist["counts"]),
                               note=f"latency_ms {obj.latency_ms:g} >= "
                                    f"last finite bucket {finite[-1]:g}")
                    rows.append(row)
                    continue
                good, bad = split_at_threshold(
                    hist["buckets"], hist["counts"], obj.latency_ms
                )
                row["p99_ms"] = quantile_from_counts(
                    hist["buckets"], hist["counts"], 0.99
                )
        elif obj.kind == "error_rate":
            good = sum(counters.get(n, 0) for n in ERROR_GOOD)
            bad = sum(counters.get(n, 0) for n in ERROR_BAD)
        else:
            good = sum(counters.get(n, 0) for n in AVAIL_GOOD)
            bad = sum(counters.get(n, 0) for n in AVAIL_BAD)
        total = good + bad
        if total <= 0:
            row.update(status="no_data", events=0)
            rows.append(row)
            continue
        frac = good / total
        violated = frac < obj.target
        row.update(
            status="violated" if violated else "ok",
            events=total, good_fraction=round(frac, 6),
            budget_consumed=round(((bad / total) / obj.budget), 4),
        )
        if violated:
            ok = False
        rows.append(row)
    return rows, ok


def load_objectives(path: str) -> List[Objective]:
    """Objectives from a JSON file: either a bare list of
    :class:`Objective` kwargs or ``{"objectives": [...]}``."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        doc = doc.get("objectives", [])
    return [Objective(**entry) for entry in doc]


def main(argv=None):
    p = argparse.ArgumentParser("orion_tpu_torch.obs.slo")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser(
        "check",
        help="evaluate a dumped registry snapshot (.json from a metrics "
             "dump) against declared objectives; exit 1 on violation — "
             "the CI gate for serving/bench runs",
    )
    c.add_argument("snapshot", help="metrics .json snapshot path")
    c.add_argument("--objectives", required=True,
                   help="JSON file: list of Objective kwargs (or "
                        "{'objectives': [...]})")
    c.add_argument("--format", choices=["text", "json"], default="text")
    args = p.parse_args(argv)
    objectives = load_objectives(args.objectives)
    with open(args.snapshot) as f:
        snap = json.load(f)
    rows, ok = check_snapshot(objectives, snap)
    if args.format == "json":
        print(json.dumps({"ok": ok, "objectives": rows}, indent=1))
    else:
        for row in rows:
            extra = ""
            if "good_fraction" in row:
                extra = (f" good={row['good_fraction']:.4%} of "
                         f"{row['events']:g} events")
            if row.get("p99_ms") is not None:
                extra += f" p99={row['p99_ms']:.2f}ms"
            print(f"[{row['status']:>8}] {row['name']} "
                  f"(target {row['target']:g}){extra}")
        print("SLO check: " + ("OK" if ok else "VIOLATED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())


__all__ = [
    "Objective", "SLOEngine", "WindowedHistogram", "SnapshotRing",
    "quantile_from_counts", "split_at_threshold", "default_objectives",
    "registry_readers", "check_snapshot", "load_objectives",
    "LATENCY_SOURCES", "ERROR_GOOD", "ERROR_BAD", "AVAIL_GOOD", "AVAIL_BAD",
]
