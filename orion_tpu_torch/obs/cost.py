"""Cost attribution and capacity observability: what every token costs. The
port's copy of ``orion_tpu/obs/cost.py``, whole (it imports no jax and no
torch).

The obs spine (metrics/trace/flight) and the SLO loop say *when* the
service is slow; this module says *where the device time goes* and *how
much headroom remains*. The O(1)-state design makes both cheap: every unit
of device work is launched from a chunk boundary on the host thread, from
program identities the host already knows (slots, chunk, bucket, qmode,
tp), so full cost accounting is host-side bookkeeping over values the
scheduler holds anyway, never a read of the card: flops and bytes enter
as plain numbers handed in by the serving layer.

Three pieces:

- :class:`CostLedger` — per-program cost entries keyed by the program's
  identity string (``decode_batched(slots=8,chunk=16,qmode=off,tp=1)``):
  flops/bytes a harvest records (the JAX package lowers its programs and
  reads XLA's ``cost_analysis()``; the port has no such harvest yet, so
  its Server records none) plus a first-call compile time when one is
  observed. The ledger converts program
  costs into per-unit weights — flops per decode slot-step, per prefill
  token, per speculative slot-round — which is what attribution and the
  flops accounting key on. With no harvested entry the weights fall back
  to an analytic per-token estimate (2 x param count), so attribution
  never depends on the harvest having run.
- :func:`attribute_chunk` — the attribution rule: ONE boundary's
  measured wall time is split across the resident slots in proportion
  to the ledger-weighted device work each slot's class did that boundary
  (decode step / prefill piece / speculative round / frozen = zero).
  The split is conservative by construction: shares sum to exactly the
  measured ``chunk_ms``, so per-request ``device_ms`` totals reconcile
  against the chunk histogram (the ``check`` gate below scores the
  residual). Idle rows still compute inside the static-shape scan; their
  cost is borne by the resident requests — the economically honest
  model, since the batch runs regardless. Ladder replays inflate the
  boundary every resident shares, proportionally.
- :class:`CapacityModel` — folds the windowed ``chunk_ms`` quantiles
  (the SLO loop's :class:`~orion_tpu_torch.obs.slo.SnapshotRing` machinery)
  with the engine shape into a live tokens/s ceiling and a headroom
  fraction: ``ceiling = slots * chunk / p50_chunk_s`` (every slot
  decoding at the observed boundary rate), ``headroom = 1 - current /
  ceiling``. Per-replica it rides ``capacity_tokens_per_s`` /
  ``capacity_current_tokens_per_s`` / ``capacity_headroom`` gauges;
  fleet-wide, :func:`fleet_capacity` recomputes headroom from the
  SUMMED ceiling and current gauges (a sum of headroom *fractions*
  would be meaningless — the aggregated registry still carries it, but
  the one number an autoscaler should read is this function's).

Tooling: ``python -m orion_tpu_torch.obs.cost check --min-headroom F
metrics.prom.json`` gates a dumped registry snapshot (exit 1 when the
reported headroom or the attribution-conservation residual violates the
bounds; ``no_data`` passes) — wired into the bench flow exactly like
``obs.slo check``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from orion_tpu_torch.obs.slo import SnapshotRing, quantile_from_counts

# request_cost_flops histogram buckets: log-spaced from kiloflops (tiny
# test configs) to petaflops (big-model serving), so one instrument
# definition covers every config without per-model tuning
FLOPS_BUCKETS = tuple(10.0 ** k for k in range(3, 16)) + (math.inf,)

# program kinds the ledger understands (the serving jit wrappers'
# registry names — generate.DECODE_PROGRAMS)
DECODE_KIND = "decode_batched"
UNIFIED_KIND = "unified_prefill"
SPEC_KIND = "spec_round"


def program_key(kind: str, **key) -> str:
    """Canonical ledger identity string for one compiled program —
    ``kind(k1=v1,k2=v2,...)`` with sorted keys, matching the
    (slots, chunk, bucket, qmode, tp) vocabulary of the serving
    programs."""
    parts = ",".join(f"{k}={key[k]}" for k in sorted(key))
    return f"{kind}({parts})"


class CostLedger:
    """Program-cost registry + the per-unit weights attribution uses.

    All values are host numbers handed in by the serving layer (a
    harvest of program costs and first-call compile observations, where
    there are any); the ledger itself never computes on device
    data. One lock guards the entry dict — readers get consistent
    copies, writers are the construction-time harvest and the rare
    compile observation."""

    def __init__(
        self,
        slots: int,
        chunk: int,
        prefill_chunk: int = 0,
        spec_depth: int = 0,
        fallback_flops_per_token: float = 0.0,
    ):
        # every input is a host number by contract (no float()/int()
        # coercions in this package: coercing is exactly how a stray
        # device scalar would sneak a read of the card in)
        self.slots = max(slots, 1)
        self.chunk = max(chunk, 1)
        self.prefill_chunk = max(prefill_chunk, 0)
        self.spec_depth = max(spec_depth, 0)
        # analytic fallback (~2 flops per weight per token): used for any
        # program the harvest didn't cover, so flops accounting degrades
        # to an estimate instead of zeros when the ledger is off
        self.fallback_flops_per_token = fallback_flops_per_token + 0.0
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}
        self._compile_ms: Dict[str, float] = {}

    # -- recording -------------------------------------------------------------

    def record(self, kind: str, key: str, flops=None, bytes_accessed=None,
               transcendentals=None, lower_ms=None, error=None) -> None:
        entry = {"kind": kind}
        if flops is not None:
            entry["flops"] = flops + 0.0
        if bytes_accessed is not None:
            entry["bytes_accessed"] = bytes_accessed + 0.0
        if transcendentals is not None:
            entry["transcendentals"] = transcendentals + 0.0
        if lower_ms is not None:
            entry["lower_ms"] = round(lower_ms, 3)
        if error is not None:
            entry["error"] = str(error)[:200]
        with self._lock:
            self._entries[key] = entry

    def note_compile(self, kind: str, ms: float) -> None:
        """First-call compile time observed by the engine (the wall time
        of the first invocation whose jit cache actually GREW — honest
        caveat: it includes that call's dispatch+execute tail)."""
        with self._lock:
            # keep the first observation: later cache growth for the
            # same kind (a wider staging bucket) is a different program,
            # but the kind-level figure should be the cold-start cost
            self._compile_ms.setdefault(kind, round(ms, 3))

    # -- reads -----------------------------------------------------------------

    def entries(self) -> Dict[str, dict]:
        with self._lock:
            out = {k: dict(v) for k, v in self._entries.items()}
            for kind, ms in self._compile_ms.items():
                for key, entry in out.items():
                    if entry.get("kind") == kind:
                        entry["compile_ms"] = ms
            return out

    def compile_times(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._compile_ms)

    def _kind_flops(self, kind: str) -> Optional[float]:
        with self._lock:
            for entry in self._entries.values():
                if entry.get("kind") == kind and "flops" in entry:
                    return entry["flops"]
        return None

    # -- per-unit weights ------------------------------------------------------

    def flops_per_decode_step(self) -> float:
        """Flops one slot's single decode step costs (the batched
        program's total over slots x chunk steps)."""
        total = self._kind_flops(DECODE_KIND)
        if total is not None and total > 0:
            return total / (self.slots * self.chunk)
        return self.fallback_flops_per_token

    def flops_per_prefill_token(self) -> float:
        """Flops one prompt token of the in-scan piece costs. Estimated
        as (unified program - decode program) / piece tokens — the
        unified chunk is the piece plus the same decode scan — clamped
        to the decode per-token cost from below (a prefill token's
        forward is at least a decode step's)."""
        dec = self.flops_per_decode_step()
        if not self.prefill_chunk:
            return dec
        uni = self._kind_flops(UNIFIED_KIND)
        plain = self._kind_flops(DECODE_KIND)
        if uni is not None and plain is not None and uni > plain:
            return max((uni - plain) / self.prefill_chunk, dec)
        return dec

    def flops_per_spec_round(self) -> float:
        """Flops one slot's speculative round costs — FIXED per round
        (depth drafts + one verify piece) regardless of how many drafts
        end up accepted, which is exactly why acceptance moves ms/tok."""
        total = self._kind_flops(SPEC_KIND)
        if total is not None and total > 0:
            return total / self.slots
        return (self.spec_depth + 1) * self.flops_per_decode_step()

    def boundary_flops(self, entry: dict) -> float:
        """The ledger-weighted device work one slot's boundary entry
        represents (the attribution weight AND the flops billed)."""
        if entry.get("frozen"):
            return 0.0
        flops = 0.0
        if entry.get("spec_round"):
            flops += self.flops_per_spec_round()
        else:
            flops += entry.get("decode_steps", 0) * self.flops_per_decode_step()
        flops += entry.get("prefill_tokens", 0) * self.flops_per_prefill_token()
        return flops


def attribute_chunk(
    ledger: CostLedger, dt_ms: float, entries: Sequence[dict]
) -> List[Tuple[dict, float, float]]:
    """Split one boundary's measured wall time across its resident
    slots: returns ``[(entry, share_ms, flops), ...]`` with
    ``sum(share_ms) == dt_ms`` exactly (conservation by construction).
    Weights are the ledger's flops estimates per entry; when every
    entry weighs zero (all frozen — not reachable from the engine's
    selection rule, but the split must still conserve) the time is
    split uniformly."""
    if not entries:
        return []
    weights = [ledger.boundary_flops(e) for e in entries]
    total = sum(weights)
    if total <= 0.0:
        share = dt_ms / len(entries)
        return [(e, share, 0.0) for e in entries]
    return [
        (e, dt_ms * w / total, w) for e, w in zip(entries, weights)
    ]


class CapacityModel:
    """Live tokens/s ceiling + headroom from the windowed chunk_ms view.

    ``read_chunk_counts`` returns the chunk_ms histogram's label-summed
    per-bucket counts (cumulative; ``Histogram.cell_total``);
    ``read_tokens`` returns the cumulative device token count (decode +
    prefill tokens the boundaries produced). Both are called OUTSIDE
    this model's lock (the SLOEngine discipline: readers take their own
    lock — the Server's stats lock — first; the two are never nested),
    return plain host numbers, and feed :class:`SnapshotRing` s so the
    window is one vector subtraction.

    The model: a boundary advances every decoding slot ``chunk`` steps,
    so the sustainable ceiling at the CURRENT boundary cost is
    ``slots * chunk / p50_chunk_s`` — what this engine shape would
    serve with every slot occupied at the latency it is actually
    measuring (compiles, qmode, tp collectives, co-tenant noise all
    priced in, which is what makes this a better autoscaler input than
    instantaneous occupancy). ``headroom = 1 - current/ceiling``,
    clamped to [0, 1]."""

    def __init__(
        self,
        slots: int,
        chunk: int,
        buckets: Sequence,
        read_chunk_counts: Callable[[], Tuple],
        read_tokens: Callable[[], float],
        clock: Callable[[], float] = time.monotonic,
        window_s: float = 30.0,
        slice_s: float = 1.0,
    ):
        self.slots = max(slots, 1)
        self.chunk = max(chunk, 1)
        self.buckets = tuple(buckets)
        self._read_counts = read_chunk_counts
        self._read_tokens = read_tokens
        self._clock = clock
        self.window_s = window_s + 0.0
        keep = max(window_s * 1.5, slice_s * 4)
        self._counts_ring = SnapshotRing(slice_s, keep)
        self._tokens_ring = SnapshotRing(slice_s, keep)
        self._lock = threading.Lock()
        self._state: dict = {"no_data": True}

    def tick(self) -> dict:
        """One chunk-boundary evaluation (readers first, lock second)."""
        now = self._clock()
        counts = tuple(self._read_counts())
        tokens = (self._read_tokens() + 0.0,)
        with self._lock:
            self._counts_ring.note(now, counts)
            self._tokens_ring.note(now, tokens)
            dcounts, win = self._counts_ring.delta(now, counts, self.window_s)
            dtokens, twin = self._tokens_ring.delta(now, tokens, self.window_s)
            boundaries = sum(dcounts)
            p50_ms = quantile_from_counts(self.buckets, dcounts, 0.5)
            out: dict = {
                "window_s": round(max(win, twin), 3),
                "boundaries": boundaries,
                "no_data": not boundaries or not p50_ms,
            }
            if boundaries and p50_ms:
                ceiling = self.slots * self.chunk * 1000.0 / p50_ms
                current = dtokens[0] / twin if twin > 0 else 0.0
                out.update(
                    p50_chunk_ms=round(p50_ms, 3),
                    p99_chunk_ms=round(
                        quantile_from_counts(self.buckets, dcounts, 0.99)
                        or 0.0, 3,
                    ),
                    ceiling_tokens_per_s=round(ceiling, 2),
                    current_tokens_per_s=round(current, 2),
                    headroom=round(
                        min(max(1.0 - current / ceiling, 0.0), 1.0), 4
                    ),
                )
            self._state = out
            return out

    def state(self) -> dict:
        """The last :meth:`tick`'s payload — never calls a reader, so
        scrape threads can read it whatever the scheduler holds."""
        with self._lock:
            return self._state

    def gauge(self, field: str) -> Callable[[], float]:
        """A registry ``gauge_fn`` callable for one state field; RAISES
        while there is no data yet, which the registry snapshot treats
        as 'cell absent' (the check gate's ``no_data``)."""

        def read():
            st = self.state()
            if st.get("no_data") or field not in st:
                raise LookupError(f"capacity has no {field} yet")
            return st[field]

        return read


def fleet_capacity(snapshot: dict) -> dict:
    """The ONE capacity figure a scale-out decision keys on, from an
    aggregated (or single-replica) registry snapshot: headroom is
    recomputed as ``1 - sum(current) / sum(ceiling)`` over every
    replica's gauges — the gauge cells SUM in
    :func:`~orion_tpu_torch.obs.metrics.aggregate`, which is correct for the
    two tokens/s figures and meaningless for a fraction."""
    ceiling = current = 0.0
    cells = 0
    for row in snapshot.get("gauges", ()):
        if row.get("name") == "capacity_tokens_per_s":
            ceiling += row.get("value") or 0.0
            cells += 1
        elif row.get("name") == "capacity_current_tokens_per_s":
            current += row.get("value") or 0.0
    # identical (name, labels) cells SUM into one aggregated row, so the
    # row count says nothing about how many replicas reported; the
    # per-source breakdown (when this is an aggregate) is the truth
    sources = snapshot.get("by_source")
    if sources:
        cells = sum(
            1 for snap in sources.values()
            if any(r.get("name") == "capacity_tokens_per_s"
                   for r in snap.get("gauges", ()))
        )
    if cells == 0 or ceiling <= 0:
        return {"no_data": True, "replicas_reporting": 0}
    return {
        "ceiling_tokens_per_s": round(ceiling, 2),
        "current_tokens_per_s": round(current, 2),
        "headroom": round(min(max(1.0 - current / ceiling, 0.0), 1.0), 4),
        "replicas_reporting": cells,
    }


# -- static evaluation of a dumped snapshot (the CI gate) ----------------------


def check_snapshot_cost(
    snap: dict,
    min_headroom: float = 0.0,
    max_attr_err: float = 0.05,
) -> Tuple[List[dict], bool]:
    """Gate a dumped registry snapshot (``MetricsRegistry.dump``'s
    ``.json`` sibling, or the fleet-aggregated dump) on the cost
    surfaces: reported capacity headroom >= ``min_headroom`` and the
    attribution-conservation residual — |chunk_ms total - attributed
    total| / chunk_ms total — <= ``max_attr_err``. A surface with zero
    events reports ``no_data`` and passes (a run that never served a
    chunk is not a violation); exit semantics mirror ``obs.slo
    check``."""
    rows: List[dict] = []
    ok = True

    # headroom: the fleet dump carries a recomputed `capacity` section;
    # otherwise score the worst (minimum) gauge cell in the snapshot
    cap = snap.get("capacity")
    if isinstance(cap, dict) and not cap.get("no_data"):
        headrooms = [cap.get("headroom")]
    else:
        headrooms = [
            row.get("value") for row in snap.get("gauges", ())
            if row.get("name") == "capacity_headroom"
            and row.get("value") is not None
        ]
    row: dict = {"name": "capacity_headroom", "min": min_headroom}
    if not headrooms or headrooms[0] is None:
        row.update(status="no_data")
    else:
        worst = min(headrooms)
        violated = worst < min_headroom
        row.update(
            status="violated" if violated else "ok",
            headroom=round(worst, 4), cells=len(headrooms),
        )
        ok = ok and not violated
    rows.append(row)

    # conservation: every chunk's wall time must have been attributed
    counters = {
        r["name"]: r["value"] for r in snap.get("counters", ())
        if not r.get("labels")
    }
    chunk_total = 0.0
    seen_chunk = False
    for r in snap.get("histograms", ()):
        if r.get("name") == "chunk_ms":
            chunk_total += r.get("sum") or 0.0
            seen_chunk = True
    row = {"name": "attribution_conservation", "max_err": max_attr_err}
    attributed = counters.get("attributed_ms_total")
    if not seen_chunk or chunk_total <= 0 or attributed is None:
        row.update(status="no_data")
    else:
        err = abs(chunk_total - attributed) / chunk_total
        violated = err > max_attr_err
        row.update(
            status="violated" if violated else "ok",
            err=round(err, 6),
            chunk_ms_total=round(chunk_total, 3),
            attributed_ms_total=round(attributed, 3),
        )
        ok = ok and not violated
    rows.append(row)
    return rows, ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser("orion_tpu_torch.obs.cost")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser(
        "check",
        help="gate a dumped registry snapshot (.json from a metrics "
             "dump, or the fleet-aggregated dump) on capacity headroom "
             "and attribution conservation; exit 1 on violation, "
             "no_data passes — the CI gate for bench runs",
    )
    c.add_argument("snapshot", help="metrics .json snapshot path")
    c.add_argument("--min-headroom", type=float, default=0.0,
                   help="reported capacity headroom must be >= this "
                        "fraction (0 = only require it be reported "
                        "sanely when present)")
    c.add_argument("--max-attr-err", type=float, default=0.05,
                   help="max |chunk_ms - attributed_ms| / chunk_ms "
                        "conservation residual")
    c.add_argument("--format", choices=["text", "json"], default="text")
    args = p.parse_args(argv)
    with open(args.snapshot) as f:
        snap = json.load(f)
    rows, ok = check_snapshot_cost(
        snap, min_headroom=args.min_headroom,
        max_attr_err=args.max_attr_err,
    )
    if args.format == "json":
        print(json.dumps({"ok": ok, "checks": rows}, indent=1))
    else:
        for row in rows:
            extra = ""
            if "headroom" in row:
                extra = f" headroom={row['headroom']:g}"
            if "err" in row:
                extra = (f" err={row['err']:g} "
                         f"(chunk {row['chunk_ms_total']:g} ms vs "
                         f"attributed {row['attributed_ms_total']:g} ms)")
            print(f"[{row['status']:>8}] {row['name']}{extra}")
        print("cost check: " + ("OK" if ok else "VIOLATED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())


__all__ = [
    "CostLedger", "CapacityModel", "attribute_chunk", "fleet_capacity",
    "check_snapshot_cost", "program_key", "FLOPS_BUCKETS",
]
