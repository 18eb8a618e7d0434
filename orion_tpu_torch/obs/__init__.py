"""Host-side observability: the port's copies of the JAX package's jax-free
``obs/`` modules, whole. Nothing here imports torch or reads the card:

- :mod:`metrics` -- :class:`MetricsRegistry` (counters, gauges, fixed-bucket
  histograms, Prometheus text and JSON exposition) and :func:`aggregate`,
  the fleet-level rollup;
- :mod:`trace` -- :class:`Tracer`, Chrome trace-event JSONL of request
  lifecycles, and :func:`merge_traces`;
- :mod:`flight` -- :class:`FlightRecorder`, the bounded ring of recent
  events that dumps on DEGRADED / DEAD, ladder exhaustion and stalls;
- :mod:`slo` -- :class:`SLOEngine`: objectives, error budgets and
  burn-rate alerts evaluated at chunk boundaries; ``python -m
  orion_tpu_torch.obs.slo check`` gates a dumped snapshot;
- :mod:`http` -- :class:`ObsHTTPServer`: ``/metrics``, ``/healthz``,
  ``/statusz``, ``/slo``, ``/costz`` and ``/profilez`` on a daemon thread;
- :mod:`cost` -- :class:`CostLedger`, ``attribute_chunk`` and
  :class:`CapacityModel`; ``python -m orion_tpu_torch.obs.cost check``
  gates a dumped snapshot on headroom and attribution conservation.
"""

from orion_tpu_torch.obs.cost import CapacityModel, CostLedger, fleet_capacity
from orion_tpu_torch.obs.flight import FlightRecorder
from orion_tpu_torch.obs.http import ObsHTTPServer
from orion_tpu_torch.obs.metrics import MetricsRegistry, aggregate
from orion_tpu_torch.obs.slo import Objective, SLOEngine, quantile_from_counts
from orion_tpu_torch.obs.trace import Tracer, merge_traces, read_jsonl, span_pairs

__all__ = [
    "MetricsRegistry", "aggregate", "Tracer", "merge_traces", "read_jsonl",
    "span_pairs", "FlightRecorder", "Objective", "SLOEngine",
    "quantile_from_counts", "ObsHTTPServer", "CostLedger", "CapacityModel",
    "fleet_capacity",
]
