"""Metrics registry: counters, gauges, and fixed-bucket histograms. The
port's copy of ``orion_tpu/obs/metrics.py``, whole (it imports no jax).

The one place every layer's gauges live. Three instrument kinds, all
labelled, all behind ONE lock so a reader gets a snapshot-consistent
view (a scrape never observes counter A after an event but counter B
before it):

- **counter** — monotonically increasing count (``inc``). The serving
  stats dict (``admitted``/``ok``/``shed``/...), ladder rung counts,
  fault deliveries.
- **gauge** — a set-to-value instrument (``set``/``inc``), plus
  *callable* gauges (``gauge_fn``) evaluated lazily at snapshot time —
  queue depth, per-slot prefill-vs-decode occupancy, compile-cache
  sizes: things whose truth lives elsewhere and would go stale as a
  stored value.
- **histogram** — fixed upper-bound buckets (cumulative counts,
  Prometheus-style ``le`` semantics) plus sum/count. Session-store
  save/load latency, chunk durations.

Hard constraint: nothing in this module -- or in any callable registered
into it -- may read the card, or call ``float()``/``int()`` on a device
tensor. Every value that enters the registry must already be a host
number; the instrumentation points all sit at chunk boundaries where the
scheduler's host mirrors make that free. The registry itself never
imports torch.

The lock is injectable so an owner can share its own (the Server passes
its stats RLock, keeping ``Server.snapshot()`` -- health + stats + slot
gauges -- one atomic read). Shared locks must be
reentrant. The clock is injectable for tests.

Exposition: :meth:`MetricsRegistry.snapshot` (plain-JSON dict),
:meth:`to_prometheus` (text format), :meth:`dump` (atomic file write of
both), and :func:`aggregate` (sum counter/histogram cells and gauge
values across replicas — the fleet-level view the supervisor builds from
child registries over the ``status`` op).
"""

from __future__ import annotations

import bisect
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# default latency buckets (milliseconds): sub-ms to tens of seconds
DEFAULT_MS_BUCKETS = (
    1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000, 10000, math.inf
)

LabelItems = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> LabelItems:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_value(v) -> str:
    if v is math.inf:
        return "+Inf"
    return f"{v:g}"


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


class Counter:
    """Monotonic count. Mutations take the registry lock."""

    def __init__(self, registry: "MetricsRegistry", name: str):
        self._registry = registry
        self.name = name

    def inc(self, n=1, labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        with self._registry._lock:
            cells = self._registry._counters[self.name]
            cells[key] = cells.get(key, 0) + n

    def value(self, labels: Optional[Dict[str, str]] = None):
        with self._registry._lock:
            return self._registry._counters[self.name].get(
                _label_key(labels), 0
            )


class Gauge:
    """Set-to-value instrument."""

    def __init__(self, registry: "MetricsRegistry", name: str):
        self._registry = registry
        self.name = name

    def set(self, v, labels: Optional[Dict[str, str]] = None) -> None:
        with self._registry._lock:
            self._registry._gauges[self.name][_label_key(labels)] = v

    def inc(self, n=1, labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        with self._registry._lock:
            cells = self._registry._gauges[self.name]
            cells[key] = cells.get(key, 0) + n

    def value(self, labels: Optional[Dict[str, str]] = None):
        with self._registry._lock:
            return self._registry._gauges[self.name].get(
                _label_key(labels), 0
            )


class Histogram:
    """Fixed-bucket histogram: per-cell cumulative-style bucket counts
    (count of observations <= each upper bound when read), plus sum and
    count. Buckets are static per instrument — label cells share them."""

    def __init__(self, registry: "MetricsRegistry", name: str,
                 buckets: Tuple[float, ...]):
        self._registry = registry
        self.name = name
        self.buckets = buckets

    def observe(self, v, labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        idx = bisect.bisect_left(self.buckets, v)
        if idx >= len(self.buckets):
            idx = len(self.buckets) - 1  # inf bucket catches everything
        with self._registry._lock:
            cells = self._registry._hists[self.name]
            cell = cells.get(key)
            if cell is None:
                cell = {"counts": [0] * len(self.buckets), "sum": 0,
                        "count": 0}
                cells[key] = cell
            cell["counts"][idx] += 1
            cell["sum"] += v
            cell["count"] += 1

    def cell(self, labels: Optional[Dict[str, str]] = None) -> Optional[dict]:
        with self._registry._lock:
            got = self._registry._hists[self.name].get(_label_key(labels))
            return None if got is None else {
                "counts": list(got["counts"]), "sum": got["sum"],
                "count": got["count"],
            }

    def cell_total(self) -> Optional[dict]:
        """Every label cell summed into one (same shape as :meth:`cell`)
        — the label-agnostic read for consumers that window the WHOLE
        instrument (a windowed p99 over 'all chunks this server ran'
        must not vanish because the cells carry labels). None when
        nothing observed yet."""
        with self._registry._lock:
            cells = self._registry._hists[self.name]
            if not cells:
                return None
            counts = [0] * len(self.buckets)
            total, n = 0, 0
            for got in cells.values():
                for i, c in enumerate(got["counts"]):
                    counts[i] += c
                total += got["sum"]
                n += got["count"]
            return {"counts": counts, "sum": total, "count": n}


class MetricsRegistry:
    """The spine's instrument store. ``lock``: an externally-owned RLock
    to share with the owner's other gauges (one atomic snapshot across
    both); default is a private RLock. ``clock`` seeds nothing today but
    rides on the snapshot payload so dumps are orderable without wall
    time."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        lock=None,
    ):
        self._clock = clock
        self._lock = lock if lock is not None else threading.RLock()
        # name -> {label_key -> value}
        self._counters: Dict[str, Dict[LabelItems, object]] = {}
        self._gauges: Dict[str, Dict[LabelItems, object]] = {}
        self._hists: Dict[str, Dict[LabelItems, dict]] = {}
        self._hist_buckets: Dict[str, Tuple[float, ...]] = {}
        # name -> [(label_key, zero-arg callable)] — evaluated at snapshot
        self._gauge_fns: Dict[str, List[Tuple[LabelItems, Callable]]] = {}
        self._instruments: Dict[str, object] = {}

    # -- instrument registration ----------------------------------------------

    def counter(self, name: str) -> Counter:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = Counter(self, name)
                self._instruments[name] = inst
                self._counters[name] = {}
            assert isinstance(inst, Counter), f"{name} is not a counter"
            return inst

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = Gauge(self, name)
                self._instruments[name] = inst
                self._gauges[name] = {}
            assert isinstance(inst, Gauge), f"{name} is not a gauge"
            return inst

    def histogram(
        self, name: str, buckets: Tuple[float, ...] = DEFAULT_MS_BUCKETS
    ) -> Histogram:
        buckets = tuple(sorted(buckets))
        if not buckets or buckets[-1] != math.inf:
            buckets = buckets + (math.inf,)  # everything lands somewhere
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = Histogram(self, name, buckets)
                self._instruments[name] = inst
                self._hists[name] = {}
                self._hist_buckets[name] = buckets
            assert isinstance(inst, Histogram), f"{name} is not a histogram"
            return inst

    def gauge_fn(
        self,
        name: str,
        fn: Callable[[], object],
        labels: Optional[Dict[str, str]] = None,
    ) -> None:
        """Register a zero-arg callable evaluated lazily at snapshot time
        (queue depth, slot occupancy, compile-cache sizes). The callable
        runs UNDER the registry lock and must be host-only and cheap --
        never a read of the card. Re-registering the same (name, labels)
        replaces the callable."""
        key = _label_key(labels)
        with self._lock:
            fns = self._gauge_fns.setdefault(name, [])
            fns[:] = [(k, f) for k, f in fns if k != key]
            fns.append((key, fn))

    # -- reads ----------------------------------------------------------------

    def counters_flat(self) -> Dict[str, object]:
        """Unlabelled counter cells as one flat {name: value} dict — the
        legacy ``Server.stats`` shape."""
        with self._lock:
            return {
                name: cells.get((), 0)
                for name, cells in self._counters.items()
            }

    def snapshot(self) -> dict:
        """Everything, consistently, as one plain-JSON dict (ONE lock
        acquisition; callable gauges evaluated inside it). Schema::

            {"t": <clock>, "counters": [{"name", "labels", "value"}],
             "gauges": [...], "histograms": [{"name", "labels",
             "buckets", "counts", "sum", "count"}]}
        """
        with self._lock:
            out = {
                "t": self._clock(),
                "counters": [], "gauges": [], "histograms": [],
            }
            for name in sorted(self._counters):
                for key, v in sorted(self._counters[name].items()):
                    out["counters"].append(
                        {"name": name, "labels": dict(key), "value": v}
                    )
            for name in sorted(self._gauges):
                for key, v in sorted(self._gauges[name].items()):
                    out["gauges"].append(
                        {"name": name, "labels": dict(key), "value": v}
                    )
            for name in sorted(self._gauge_fns):
                for key, fn in self._gauge_fns[name]:
                    try:
                        v = fn()
                    except Exception:
                        continue  # a broken gauge must not break the scrape
                    out["gauges"].append(
                        {"name": name, "labels": dict(key), "value": v}
                    )
            for name in sorted(self._hists):
                buckets = [
                    "+Inf" if b is math.inf else b
                    for b in self._hist_buckets[name]
                ]
                for key, cell in sorted(self._hists[name].items()):
                    out["histograms"].append({
                        "name": name, "labels": dict(key),
                        "buckets": buckets,
                        "counts": list(cell["counts"]),
                        "sum": cell["sum"], "count": cell["count"],
                    })
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition of :meth:`snapshot` (cumulative
        ``le`` buckets for histograms)."""
        return prometheus_from_snapshot(self.snapshot())

    def dump(self, path: str) -> None:
        """Atomic write of the Prometheus text at ``path`` and the JSON
        snapshot at ``path + '.json'`` (tmp-then-``os.replace`` — a kill
        mid-dump leaves the previous scrape intact, the repo's
        ``non-atomic-persist`` idiom)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        # ONE snapshot renders both files — two independent reads could
        # disagree across an increment landing between them (and would
        # evaluate every callable gauge twice per scrape)
        snap = self.snapshot()
        text = prometheus_from_snapshot(snap)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
        tmp = path + ".json.tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=1, default=repr)
        os.replace(tmp, path + ".json")


def prometheus_from_snapshot(snap: dict) -> str:
    """Prometheus text from any snapshot-SHAPED dict — a live registry's
    :meth:`MetricsRegistry.snapshot`, one read back from a ``status`` op,
    or the fleet-level :func:`aggregate` rollup (same row schema)."""
    lines: List[str] = []

    def cell_labels(labels: Dict[str, str], extra: str = "") -> str:
        parts = [f'{_sanitize(k)}="{v}"' for k, v in sorted(labels.items())]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    seen_type = set()

    def typeline(name: str, kind: str) -> None:
        if name not in seen_type:
            seen_type.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for row in snap.get("counters", ()):
        name = _sanitize(row["name"])
        typeline(name, "counter")
        lines.append(
            f"{name}{cell_labels(row['labels'])} "
            f"{_fmt_value(row['value'])}"
        )
    for row in snap.get("gauges", ()):
        name = _sanitize(row["name"])
        typeline(name, "gauge")
        lines.append(
            f"{name}{cell_labels(row['labels'])} "
            f"{_fmt_value(row['value'])}"
        )
    for row in snap.get("histograms", ()):
        name = _sanitize(row["name"])
        typeline(name, "histogram")
        cum = 0
        for b, c in zip(row["buckets"], row["counts"]):
            cum += c
            le = "+Inf" if b == "+Inf" else _fmt_value(b)
            extra = 'le="%s"' % le
            lines.append(
                f"{name}_bucket"
                f"{cell_labels(row['labels'], extra)} {cum}"
            )
        lines.append(
            f"{name}_sum{cell_labels(row['labels'])} "
            f"{_fmt_value(row['sum'])}"
        )
        lines.append(
            f"{name}_count{cell_labels(row['labels'])} {row['count']}"
        )
    return "\n".join(lines) + "\n"


def snapshot_value(
    snap: dict, name: str, labels: Optional[Dict[str, str]] = None
):
    """One cell out of a snapshot-shaped dict (``MetricsRegistry
    .snapshot()`` or :func:`aggregate`'s rollup): the value of the
    counter or gauge row matching ``name`` — and, when ``labels`` is
    given, exactly those labels. ``None`` when no row matches; with
    ``name`` alone and several labeled cells, their sum (the flat
    counter semantics of ``counters_flat``, but against a snapshot a
    bench or test already holds instead of a live registry)."""
    want = dict(labels) if labels is not None else None
    total = None
    for section in ("counters", "gauges"):
        for row in snap.get(section, ()):
            if row.get("name") != name:
                continue
            if want is not None and dict(row.get("labels") or {}) != want:
                continue
            total = (total or 0) + row["value"]
    return total


def aggregate(
    snapshots: List[dict], sources: Optional[List[str]] = None
) -> dict:
    """Fleet-level rollup of N registry snapshots (the supervisor feeds
    child snapshots scraped over the ``status`` op): counter and
    histogram cells with identical (name, labels) SUM; gauges sum too
    (queue depths and slot counts add across replicas — a per-replica
    view is in ``by_source`` when ``sources`` names them)."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    by_source = {}
    for i, snap in enumerate(snapshots):
        if snap is None:
            continue
        name = sources[i] if sources and i < len(sources) else f"src-{i}"
        by_source[name] = snap
        for row in snap.get("counters", ()):
            key = (row["name"], _label_key(row.get("labels")))
            out["counters"][key] = out["counters"].get(key, 0) + row["value"]
        for row in snap.get("gauges", ()):
            key = (row["name"], _label_key(row.get("labels")))
            out["gauges"][key] = out["gauges"].get(key, 0) + row["value"]
        for row in snap.get("histograms", ()):
            key = (row["name"], _label_key(row.get("labels")))
            cell = out["histograms"].get(key)
            if cell is None:
                out["histograms"][key] = {
                    "buckets": list(row["buckets"]),
                    "counts": list(row["counts"]),
                    "sum": row["sum"], "count": row["count"],
                }
            elif cell["buckets"] == list(row["buckets"]):
                cell["counts"] = [
                    a + b for a, b in zip(cell["counts"], row["counts"])
                ]
                cell["sum"] += row["sum"]
                cell["count"] += row["count"]

    def rows(d, hist=False):
        out_rows = []
        for (name, key), v in sorted(d.items()):
            row = {"name": name, "labels": dict(key)}
            if hist:
                row.update(v)
            else:
                row["value"] = v
            out_rows.append(row)
        return out_rows

    return {
        "counters": rows(out["counters"]),
        "gauges": rows(out["gauges"]),
        "histograms": rows(out["histograms"], hist=True),
        "sources": sorted(by_source),
        "by_source": by_source,
    }


__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "aggregate",
    "prometheus_from_snapshot", "snapshot_value", "DEFAULT_MS_BUCKETS",
]
