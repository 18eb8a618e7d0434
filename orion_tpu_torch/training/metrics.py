"""Training metrics: one JSON line per log point, plus a readable stdout
line with tokens/s.

The port's counterpart of ``orion_tpu/training/metrics.py`` without the
telemetry registry and its Prometheus dump (``obs/metrics.py``; ROADMAP.md
queue A, A9b). The trainer hands over host floats at log cadence.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self._f = open(path, "a") if path else None
        self._last_time: Optional[float] = None
        self._last_step: Optional[int] = None

    def log(self, step: int, metrics: Dict[str, float], tokens_per_step: int = 0):
        now = time.perf_counter()
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self._last_time is not None and tokens_per_step and step > self._last_step:
            dt = now - self._last_time
            rec["tokens_per_sec"] = tokens_per_step * (step - self._last_step) / dt
            rec["step_time_ms"] = 1000.0 * dt / (step - self._last_step)
        self._last_time, self._last_step = now, step
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        parts = [f"step {rec['step']:>7d}"]
        for k in ("loss", "ppl", "grad_norm", "lr", "tokens_per_sec", "step_time_ms",
                  "eval_loss", "eval_ppl"):
            if k in rec:
                parts.append(f"{k} {rec[k]:.4g}")
        print("  ".join(parts), flush=True)

    def close(self):
        if self._f:
            self._f.close()


__all__ = ["MetricsLogger"]
