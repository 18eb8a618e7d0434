"""Training metrics: one JSON line per log point and a readable stdout line
with tokens/s, over the telemetry registry.

The port's counterpart of ``orion_tpu/training/metrics.py``. The logger is
a view over ``obs.metrics.MetricsRegistry`` (the registry the Server and the
fleet expose): steps count into ``train_steps_total``, step wall time feeds
the ``step_time_ms`` histogram, and every scalar handed over lands in the
``train{metric=...}`` gauge, so one scrape covers a box that trains and
serves. ``dump(path)`` writes the Prometheus text and its ``.json`` sibling
(the train CLI's ``--metrics-path``). The trainer hands over host floats at
log cadence; nothing here reads the card.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional

from orion_tpu_torch.obs.metrics import MetricsRegistry


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stream=None,
                 registry: Optional[MetricsRegistry] = None):
        self._f = open(path, "a") if path else None
        self._stream = stream
        self._last_time: Optional[float] = None
        self._last_step: Optional[int] = None
        self.registry = registry if registry is not None else MetricsRegistry()
        self._c_steps = self.registry.counter("train_steps_total")
        self._h_step_ms = self.registry.histogram("step_time_ms")

    def log(self, step: int, metrics: Dict[str, float], tokens_per_step: int = 0):
        now = time.perf_counter()
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self._last_time is not None and tokens_per_step and step > self._last_step:
            dt = now - self._last_time
            rec["tokens_per_sec"] = tokens_per_step * (step - self._last_step) / dt
            rec["step_time_ms"] = 1000.0 * dt / (step - self._last_step)
            self._h_step_ms.observe(rec["step_time_ms"])
        if self._last_step is not None and step > self._last_step:
            self._c_steps.inc(step - self._last_step)
        self._last_time, self._last_step = now, step
        g = self.registry.gauge("train")
        g.set(step, labels={"metric": "step"})
        for k, v in rec.items():
            if k != "step":
                g.set(v, labels={"metric": k})
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        parts = [f"step {rec['step']:>7d}"]
        for k in ("loss", "ppl", "grad_norm", "lr", "tokens_per_sec", "step_time_ms",
                  "eval_loss", "eval_ppl"):
            if k in rec:
                parts.append(f"{k} {rec[k]:.4g}")
        print("  ".join(parts), file=self._stream or sys.stdout, flush=True)

    def dump(self, path: str) -> None:
        """The registry's Prometheus text at ``path`` and its JSON snapshot
        at ``path + '.json'``, each published atomically."""
        self.registry.dump(path)

    def close(self):
        if self._f:
            self._f.close()


__all__ = ["MetricsLogger"]
